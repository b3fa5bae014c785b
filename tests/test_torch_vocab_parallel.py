"""The vocabulary-parallel cross-entropy and the sharded step whose logits
stay sharded over the vocabulary, on ``gloo`` ranks spawned once for the
file (2 and 4 processes at once).

When the model axis t divides the vocabulary V, the head is sharded over
it (the untied ``lm_head`` (d, V/t), or the tied ``embed`` (V/t, d) seen
transposed) and each model rank keeps its own V/t columns of the logits,
as the JAX package constrains them to ("batch", None, "vocab");
``collectives.vocab_parallel_cross_entropy`` reduces the row max, the sum
of exponentials and the gold logit over the model axis.  Held here:

* the loss and dlogits of ``vocab_parallel_cross_entropy`` at t = 2 and
  4 against ``models.cross_entropy`` and its autograd on the whole
  logits, and against the JAX package's ``cross_entropy`` and
  ``jax.grad`` of it on the same logits: float32 within 1e-6 relative
  (max |d| <= 1e-6 max |g| for the gradient: the ranks sum the
  exponentials in other orders), bfloat16 within 2e-2 (the JAX package's
  multi-device tolerance);
* the sharded step at (data, model) = (1, 2) and (2, 2), ZeRO 0, 1 and 3,
  against the single-process step, to the tolerances of
  tests/test_torch_multirank_harness.py: llama3.2-3b smoke (tied, V =
  512), stablelm-12b smoke (untied, V = 512) and gpt2-350m smoke at V =
  509, which no t > 1 divides, so its logits stay whole on every rank;
  the tied and untied configs at (2, 2), ZeRO 1, also against the JAX
  package's sharded step on 4 host devices (bf16 losses and step 1's
  grad norm within 2e-2);
* under a ``TorchDispatchMode``, no tensor whose last dim is V is made on
  a model rank while it runs a microbatch forward and backward when t
  divides V, and the 509 config, whose logits are replicated, makes some
  (the detector sees them).
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.models import cross_entropy, param_shapes
from repro_torch.parallel import collectives as col
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import (accumulate_grads, build_train_step,
                                          make_local_state, make_train_state,
                                          resolve_microbatches, state_specs)
from test_torch_multirank_harness import (  # noqa: F401 (one_thread: autouse)
    B, GNORM_RTOL, GRAD_TOL, LOSS_TOL, S, as_fp32, bad_shards, batches,
    jax_results, join_ranks, one_thread, spawn_ranks, start_jax,
    train_config)

ARCHS = {"tied": "llama3.2-3b", "untied": "stablelm-12b", "odd": "gpt2-350m"}
ZEROS = [0, 1, 3]
MESHES = {2: (1, 2), 4: (2, 2)}
CASES = [(world, kind, zero) for world in MESHES for kind in ARCHS
         for zero in ZEROS]
# the vocabulary-sharded configs also run in the JAX package's sharded step
JAX_WORLD, JAX_ZERO, JAX_KINDS = 4, 1, ("tied", "untied")
JAX_JOBS = [{"arch": ARCHS[kind], "fields": {}, "mesh": MESHES[JAX_WORLD],
             "zero": JAX_ZERO} for kind in JAX_KINDS]
# the cross-entropy alone: (rows, positions) of logits over the vocabulary
CE_SHAPE, CE_VOCAB = (3, 7), 512
CE_TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def config(kind):
    cfg = smoke_config(ARCHS[kind])
    return cfg.scaled(vocab_size=509) if kind == "odd" else cfg


def ce_inputs(dtype):
    """Logits (CE_SHAPE + (CE_VOCAB,)) and labels from a seed, with the
    labels at both ends of the vocabulary included."""
    rng = np.random.default_rng(11)
    logits = torch.from_numpy(
        rng.standard_normal(CE_SHAPE + (CE_VOCAB,), dtype=np.float32) * 3)
    labels = torch.from_numpy(rng.integers(0, CE_VOCAB, CE_SHAPE))
    labels[0, :2] = torch.tensor([0, CE_VOCAB - 1])
    return logits.to(getattr(torch, dtype)), labels


class WideTensors(TorchDispatchMode):
    """Records each op whose output has ``width`` as its last dim."""

    def __init__(self, width):
        super().__init__()
        self.width, self.seen = width, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dim() \
                    and t.shape[-1] == self.width:
                self.seen.append(f"{func} {tuple(t.shape)}")
        return out


def _ce(rank, world):
    """Loss and gathered dlogits of the vocabulary-parallel cross-entropy
    with the world as the model axis (t = world), each dtype."""
    out = {}
    for dtype in CE_TOL:
        logits, labels = ce_inputs(dtype)
        local = logits.chunk(world, -1)[rank].clone().requires_grad_(True)
        loss = col.vocab_parallel_cross_entropy(local, labels,
                                                dist.group.WORLD, rank)
        loss.backward()
        parts = [torch.empty_like(local.grad) for _ in range(world)]
        dist.all_gather(parts, local.grad)
        out[dtype] = (float(loss), torch.cat(parts, -1).float().numpy())
    return out


def _case(kind, d, t, zero):
    """Step 1's accumulated fp32 gradients gathered, the grad norm, four
    bf16 losses, step 1's bf16 grad norm and the shards that differ from
    the specs' shapes."""
    cfg, tc = config(kind), train_config(zero)
    mesh = make_plan_mesh(d, t, device_type="cpu")
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
    metrics = [step(state, batch)[1] for batch in data]
    return {"grads": grads, "gnorm": gnorm, "bad": bad,
            "losses": [float(m["loss"]) for m in metrics],
            "bf16_gnorm": float(metrics[0]["grad_norm"])}


def _wide(kind, d, t):
    """The ops of one ZeRO 1 microbatch forward and backward on this rank
    that made a tensor whose last dim is the vocabulary."""
    cfg, tc = config(kind), train_config(1)
    mesh = make_plan_mesh(d, t, device_type="cpu")
    step, _ = build_train_step(cfg, tc, B, S, mesh=mesh)
    state = make_local_state(cfg, tc, mesh, device="cpu")
    batch = batches(cfg, step.rows)[0]
    with WideTensors(cfg.vocab_size) as mode:
        step.accumulate(state["params"], batch)
    return mode.seen


def _work(rank, world, out_dir):
    out = {}
    ce = _ce(rank, world)
    if rank == 0:
        np.savez(os.path.join(out_dir, "ce.npz"),
                 **{dt: g for dt, (_, g) in ce.items()})
    out["ce"] = {dt: loss for dt, (loss, _) in ce.items()}
    d, t = MESHES[world]
    for w, kind, zero in CASES:
        if w != world:
            continue
        res = _case(kind, d, t, zero)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{kind}-{zero}.npz"),
                     *res["grads"])
        out[f"{kind}-{zero}"] = {k: res[k] for k in ("gnorm", "losses",
                                                     "bf16_gnorm", "bad")}
    for kind in ARCHS:
        out[f"wide-{kind}"] = _wide(kind, d, t)
    return out


def _single():
    """{kind: (fp32 step-1 grads, grad norm, bf16 losses)} of the
    single-process step."""
    out = {}
    for kind in ARCHS:
        cfg, tc = config(kind), train_config(1)
        data = batches(cfg)
        state = as_fp32(make_train_state(cfg, tc, device="cpu"))
        grads, _ = accumulate_grads(cfg, tc, state["params"], data[0],
                                    resolve_microbatches(tc, B))
        gnorm = float(torch.sqrt(sum(torch.sum(g * g)
                                     for g in tree_leaves(grads))))
        step, _ = build_train_step(cfg, tc, B, S)
        state = make_train_state(cfg, tc, device="cpu")
        losses = [float(step(state, batch)[1]["loss"]) for batch in data]
        out[kind] = ([g.numpy() for g in tree_leaves(grads)], gnorm, losses)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(ranks, single, the JAX runs): ranks {world: (out_dir, [each rank's
    results])} from one spawn per world size; both spawns, the JAX
    subprocess and the single-process reference at once."""
    dirs = {world: tmp_path_factory.mktemp(f"vocab{world}")
            for world in MESHES}
    jax_run = start_jax(dirs[JAX_WORLD], JAX_JOBS)
    try:
        spawns = {world: spawn_ranks(_work, world, dirs[world])
                  for world in MESHES}
        single = _single()
        ranks = {world: (dirs[world], join_ranks(ctx, world, dirs[world]))
                 for world, ctx in spawns.items()}
    except BaseException:
        jax_run.kill()
        raise
    return ranks, single, jax_results(jax_run)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def single(runs):
    return runs[1]


def _jax_ce(dtype):
    """The JAX package's ``cross_entropy`` of ``ce_inputs(dtype)`` and
    ``jax.grad`` of it, as (loss, dlogits in float32)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.transformer import cross_entropy as jax_cross_entropy
    logits, labels = ce_inputs(dtype)
    x = jnp.asarray(logits.float().numpy()).astype(getattr(jnp, dtype))
    y = jnp.asarray(labels.numpy())
    loss, grad = jax.value_and_grad(jax_cross_entropy)(x, y)
    return float(loss), np.asarray(grad.astype(jnp.float32))


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("dtype", sorted(CE_TOL))
def test_cross_entropy_matches_the_gathered_logits(ranks, world, dtype):
    """t = world: every rank's loss and the gathered dlogits against
    ``cross_entropy`` of the whole logits and its autograd, and against
    the JAX package's ``cross_entropy`` and its ``jax.grad``."""
    out_dir, res = ranks[world]
    logits, labels = ce_inputs(dtype)
    logits.requires_grad_(True)
    want = cross_entropy(logits, labels)
    want.backward()
    refs = {"port": (want.item(), logits.grad.float().numpy()),
            "jax": _jax_ce(dtype)}
    tol = CE_TOL[dtype]
    got = np.load(out_dir / "ce.npz")[dtype]
    for ref, (loss, g_want) in refs.items():
        for r in res:
            assert abs(r["ce"][dtype] - loss) <= tol * abs(loss), ref
        assert got.shape == g_want.shape, ref
        err = np.abs(got - g_want).max()
        assert err <= tol * np.abs(g_want).max(), (ref, err)


def _key(kind, zero):
    return f"{kind}-{zero}"


STEP_IDS = [f"{kind}-{'x'.join(map(str, MESHES[w]))}-zero{z}"
            for w, kind, z in CASES]


@pytest.mark.parametrize("world,kind,zero", CASES, ids=STEP_IDS)
def test_step1_grads_match_single_process(ranks, single, world, kind, zero):
    out_dir, res = ranks[world]
    got = np.load(out_dir / f"{_key(kind, zero)}.npz")
    want, want_norm, _ = single[kind]
    assert len(got.files) == len(want)
    for i, w in enumerate(want):
        g = got[f"arr_{i}"]
        assert g.shape == w.shape, i
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), i
    for r in res:
        got_norm = r[_key(kind, zero)]["gnorm"]
        assert abs(got_norm - want_norm) <= GNORM_RTOL * want_norm


@pytest.mark.parametrize("world,kind,zero", CASES, ids=STEP_IDS)
def test_bf16_losses_match_single_process(ranks, single, world, kind, zero):
    _, res = ranks[world]
    want = single[kind][2]
    for r in res:
        got = r[_key(kind, zero)]["losses"]
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
        assert got[-1] < got[0]
        assert r[_key(kind, zero)]["bad"] == []


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_no_full_vocabulary_tensor_on_a_model_rank(ranks, world, kind):
    """t = 2 divides V = 512: no op of a microbatch forward and backward
    makes a tensor whose last dim is V on any rank.  V = 509: the
    replicated logits are such tensors, and the detector records them."""
    _, res = ranks[world]
    for r in res:
        seen = r[f"wide-{kind}"]
        if kind == "odd":
            assert seen
        else:
            assert seen == [], seen[:5]


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_bf16_losses_match_the_jax_sharded_step(runs, kind):
    """The vocabulary-sharded configs at (2, 2), ZeRO 1: every rank's four
    bf16 losses and step 1's bf16 grad norm against the JAX package's
    sharded step (logits constrained to ("batch", None, "vocab")) on 4
    host devices, from the same parameters and batches."""
    ranks, _, jax_out = runs
    want = jax_out[JAX_KINDS.index(kind)]
    res = ranks[JAX_WORLD][1]
    for r in res:
        got = r[_key(kind, JAX_ZERO)]
        assert len(got["losses"]) == len(want["losses"])
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        assert abs(got["bf16_gnorm"] - want["grad_norm"]) \
            <= LOSS_TOL * want["grad_norm"]
