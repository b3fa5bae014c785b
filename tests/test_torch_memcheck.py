"""The port's Fig 6 driver (``repro_torch.launch.memcheck``): its combos are
the JAX package's, rank 0's state under the fake process group holds
exactly the specs' shards, one sharded step runs on that state, and the
driver refuses a device without CUDA's allocator.  The same for
``chip_smoke.py``'s phase (f) plans of the MLA, MoE and Mamba2 families
(``FAMILY_PLANS``): rank 0's state of each whole plan on the meta device,
and one step of each at smoke widths; for its phase (q) plans on the
head_dim / seq fallback (``SEQ_PLANS``), rank 0's and rank 15's; and for
its phase (p) plans on the two-pod (2, 16, 16) mesh (``POD_PLANS``).

The JAX module sets ``XLA_FLAGS`` when it is imported, which would change
the CPU device count of every later JAX test in this process, so its
``COMBOS`` are read from its source instead.
"""
import ast
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch import memcheck
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.launch.train import compute_dtype, to_device
from repro_torch.models import param_shapes
from repro_torch.parallel import collectives as col
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import (build_train_step,
                                          check_sharded_supported,
                                          make_local_state, state_specs)

ROOT = Path(__file__).resolve().parents[1]
COMBOS = memcheck.COMBOS


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()
FAMILY = [(arch, cut, b, d, t, zero)
          for arch, cut, b, d, t, zeros in CHIP_SMOKE.FAMILY_PLANS
          for zero in zeros]
FAMILY_IDS = [f"{a}-b{b}-{d}x{t}-zero{z}" for a, _, b, d, t, z in FAMILY]
SEQ = [(arch, rank) for arch, ranks in CHIP_SMOKE.SEQ_PLANS for rank in ranks]
SEQ_IDS = [f"{a}-rank{r}" for a, r in SEQ]
POD = CHIP_SMOKE.POD_PLANS


def jax_combos():
    tree = ast.parse((ROOT / "src/repro/launch/memcheck.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "COMBOS":
            return ast.literal_eval(node.value)
    raise AssertionError("no COMBOS in the JAX memcheck")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: smoke-sized products, and the other test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_combos_are_the_jax_packages():
    assert COMBOS == jax_combos()


@pytest.mark.parametrize("zero", [0, 1, 3])
@pytest.mark.parametrize("arch,batch,seq,d,t", COMBOS,
                         ids=[f"{a}-b{b}-{d}x{t}" for a, b, _, d, t in COMBOS])
def test_rank0_state_is_the_specs_shards(arch, batch, seq, d, t, zero):
    """Rank 0's state of each combo's plan (smoke widths, fake group): every
    leaf has its spec's local shape in storage of its own, and the bytes
    are the specs' sum (nothing of a whole leaf is kept)."""
    cfg = smoke_config(arch)
    tc = TrainConfig(global_batch=batch, seq_len=64, microbatch=1, zero=zero)
    with memcheck.fake_world(d * t):
        mesh = make_plan_mesh(d, t, device_type="cpu")
        state = make_local_state(cfg, tc, mesh, device="cpu")
        specs = state_specs(cfg, tc, mesh, param_shapes(cfg))
        shapes = tree_leaves(param_shapes(cfg))
        for part, spec_tree in ((state["params"], specs["params"]),
                                *((state["opt"][k], specs["opt"][k])
                                  for k in ("master", "m", "v"))):
            for leaf, spec, shape in zip(tree_leaves(part),
                                         tree_leaves(spec_tree), shapes):
                assert tuple(leaf.shape) == col.local_shape(shape, spec, mesh)
                assert leaf.untyped_storage().nbytes() == \
                    leaf.numel() * leaf.element_size()
        assert memcheck.storage_bytes(state) == \
            memcheck.local_state_bytes(cfg, tc, mesh)


@pytest.mark.parametrize("arch,batch,seq,d,t",
                         [c for c in COMBOS if c[3] * c[4] > 1],
                         ids=[f"{a}-b{b}-{d}x{t}" for a, b, _, d, t in COMBOS
                              if d * t > 1])
def test_one_sharded_step_runs_under_the_fake_group(arch, batch, seq, d, t):
    """The memcheck path at smoke widths on the CPU: one sharded step of
    rank 0 runs at ZeRO 1, the local state keeps its shapes (the values
    the fake group leaves mean nothing)."""
    cfg = smoke_config(arch)
    tc = TrainConfig(global_batch=batch, seq_len=64, microbatch=1, zero=1)
    with memcheck.fake_world(d * t):
        mesh = make_plan_mesh(d, t, device_type="cpu")
        state = make_local_state(cfg, tc, mesh, device="cpu")
        before = [tuple(x.shape) for x in tree_leaves(state["params"])]
        step, _ = build_train_step(cfg, tc, batch, 64, mesh=mesh)
        batch_ = to_device(next(SyntheticTokens(
            cfg, batch, 64, seed=0, rows=step.rows)), "cpu",
            compute_dtype(state))
        state, _ = step(state, batch_)
        assert state["step"] == 1
        assert [tuple(x.shape) for x in tree_leaves(state["params"])] == before


def _assert_specs_shards(cfg, tc, mesh, state):
    """Every leaf of params, master, m and v has its spec's local shape,
    and their bytes are the specs' sum."""
    specs = state_specs(cfg, tc, mesh, param_shapes(cfg))
    shapes = tree_leaves(param_shapes(cfg))
    total = 0
    for part, spec_tree in ((state["params"], specs["params"]),
                            *((state["opt"][k], specs["opt"][k])
                              for k in ("master", "m", "v"))):
        for leaf, spec, shape in zip(tree_leaves(part),
                                     tree_leaves(spec_tree), shapes):
            assert tuple(leaf.shape) == col.local_shape(shape, spec, mesh)
            total += leaf.numel() * leaf.element_size()
    assert total == memcheck.local_state_bytes(cfg, tc, mesh)


@pytest.mark.parametrize("whole_leaves", [True, False])
@pytest.mark.parametrize("arch,cut,batch,d,t,zero", FAMILY, ids=FAMILY_IDS)
def test_family_plan_rank0_state_is_the_specs_shards(arch, cut, batch, d, t,
                                                     zero, whole_leaves):
    """Phase (f)'s plans whole (deepseek-v2-236b on (16,16) among them):
    the step accepts each, and rank 0's state on the meta device -- its
    leaves drawn whole and cut, or drawn at their shard shapes as phase (f)
    draws them -- is exactly its specs' shards."""
    cfg = get_arch(arch).scaled(**cut) if cut else get_arch(arch)
    tc = TrainConfig(global_batch=batch, seq_len=1024, microbatch=1,
                     zero=zero)
    with memcheck.fake_world(d * t):
        mesh = make_plan_mesh(d, t, device_type="cpu")
        check_sharded_supported(cfg, tc, mesh)
        state = make_local_state(cfg, tc, mesh, device="meta",
                                 whole_leaves=whole_leaves)
        _assert_specs_shards(cfg, tc, mesh, state)


@pytest.mark.parametrize("arch,cut,batch,d,t,zero", FAMILY, ids=FAMILY_IDS)
def test_family_plan_step_runs_under_the_fake_group(arch, cut, batch, d, t,
                                                    zero):
    """Phase (f)'s path at smoke widths on (2, 2): rank 0's shards drawn at
    their own shapes, one sharded step under the fake group.  What the
    rank receives is zeroed, so the loss is finite; the state keeps its
    shapes."""
    cfg = smoke_config(arch).scaled(**cut)
    tc = TrainConfig(global_batch=4, seq_len=64, microbatch=1, zero=zero)
    with memcheck.fake_world(4):
        mesh = make_plan_mesh(2, 2, device_type="cpu")
        state = make_local_state(cfg, tc, mesh, device="cpu",
                                 whole_leaves=False)
        _assert_specs_shards(cfg, tc, mesh, state)
        before = [tuple(x.shape) for x in tree_leaves(state["params"])]
        step, _ = build_train_step(cfg, tc, 4, 64, mesh=mesh)
        batch_ = to_device(next(SyntheticTokens(
            cfg, 4, 64, seed=0, rows=step.rows)), "cpu",
            compute_dtype(state))
        state, metrics = step(state, batch_)
        assert state["step"] == 1
        assert math.isfinite(float(metrics["loss"]))
        assert [tuple(x.shape) for x in tree_leaves(state["params"])] == before


@pytest.mark.parametrize("arch,rank", SEQ, ids=SEQ_IDS)
def test_seq_plan_state_is_the_specs_shards(arch, rank):
    """Phase (q)'s plans on the head_dim / seq fallback, whole at (16, 16)
    and train_4k: the step accepts each at the serverless default ZeRO
    stage, and the rank's state on the meta device, drawn at its shard
    shapes as phase (q) draws it, is exactly its specs' shards."""
    cfg, tc, d, t = CHIP_SMOKE.seq_plan_config(arch)
    with memcheck.fake_world(d * t, rank):
        mesh = make_plan_mesh(d, t, device_type="cpu")
        assert col.mesh_coords(mesh) == {"data": rank // t,
                                         "model": rank % t}
        check_sharded_supported(cfg, tc, mesh)
        state = make_local_state(cfg, tc, mesh, device="meta",
                                 whole_leaves=False)
        _assert_specs_shards(cfg, tc, mesh, state)


@pytest.mark.parametrize("rank", [0, 3])
def test_seq_fallback_step_runs_under_the_fake_group(rank):
    """Phase (q)'s path at smoke widths: starcoder2-3b smoke (8/2 heads)
    on (1, 4), as rank 0 and rank 3 (query offset 48 of 64) under the fake
    group, whose all-to-all and gathers write nothing (what the rank
    receives is zeroed): one step, a finite loss, the shapes kept."""
    cfg = smoke_config("starcoder2-3b")
    tc = TrainConfig(global_batch=4, seq_len=64, microbatch=1, zero=1)
    with memcheck.fake_world(4, rank):
        mesh = make_plan_mesh(1, 4, device_type="cpu")
        state = make_local_state(cfg, tc, mesh, device="cpu",
                                 whole_leaves=False)
        before = [tuple(x.shape) for x in tree_leaves(state["params"])]
        step, _ = build_train_step(cfg, tc, 4, 64, mesh=mesh)
        batch_ = to_device(next(SyntheticTokens(
            cfg, 4, 64, seed=0, rows=step.rows)), "cpu",
            compute_dtype(state))
        state, metrics = step(state, batch_)
        assert math.isfinite(float(metrics["loss"]))
        assert [tuple(x.shape) for x in tree_leaves(state["params"])] == before


def test_run_one_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        memcheck.run_one("gpt2-350m", 8, 1024, 2, 1, zero=1, device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.gpu
def test_run_one_smoke_combo_on_the_card(cuda):
    """One smoke combo as rank 0 of (2, 2) on the card: a row with a peak
    above the state and both accuracies."""
    row = memcheck.run_one("gpt2-350m", 8, 256, 2, 2, zero=1,
                           cfg=smoke_config("gpt2-350m"))
    assert row["actual_bytes"] > row["state_bytes"] > 0
    assert -10 < row["acc_exact"] <= 1 and -10 < row["acc_paper"] <= 1


@pytest.mark.parametrize("arch", POD)
def test_pod_plan_state_is_the_specs_shards(arch):
    """Phase (p)'s plans whole on (2, 16, 16) with the pod axis, at
    train_4k and global batch 32: the step accepts each at the serverless
    default ZeRO stage, and rank 0's state on the meta device, drawn at
    its shard shapes as phase (p) draws it, is exactly its specs' shards
    (the data axes split as one axis of 32)."""
    cfg, tc, pods, d, t = CHIP_SMOKE.pod_plan_config(arch)
    assert (pods, d, t) == (2, 16, 16) and tc.global_batch == 32
    with memcheck.fake_world(pods * d * t):
        mesh = make_plan_mesh(d, t, device_type="cpu", pods=pods)
        assert col.mesh_coords(mesh) == {"pod": 0, "data": 0, "model": 0}
        assert col.data_group(mesh)[1:] == (32, 0)
        check_sharded_supported(cfg, tc, mesh)
        state = make_local_state(cfg, tc, mesh, device="meta",
                                 whole_leaves=False)
        _assert_specs_shards(cfg, tc, mesh, state)


@pytest.mark.parametrize("rank", [0, 5])
@pytest.mark.parametrize("arch", POD)
def test_pod_step_runs_under_the_fake_group(arch, rank):
    """Phase (p)'s path at smoke widths on (2, 2, 2) at the plan's ZeRO
    stage, as rank 0 and rank 5 (pod 1, data 0, model 1): the rank's
    shards drawn at their own shapes, one step under the fake group, a
    finite loss, the shapes kept."""
    cfg = smoke_config(arch)
    zero = CHIP_SMOKE.pod_plan_config(arch)[1].zero
    tc = TrainConfig(global_batch=4, seq_len=64, microbatch=1, zero=zero)
    with memcheck.fake_world(8, rank):
        mesh = make_plan_mesh(2, 2, device_type="cpu", pods=2)
        assert col.data_group(mesh)[1:] == (4, 2 * (rank // 4)
                                            + rank // 2 % 2)
        state = make_local_state(cfg, tc, mesh, device="cpu",
                                 whole_leaves=False)
        _assert_specs_shards(cfg, tc, mesh, state)
        before = [tuple(x.shape) for x in tree_leaves(state["params"])]
        step, _ = build_train_step(cfg, tc, 4, 64, mesh=mesh)
        batch_ = to_device(next(SyntheticTokens(
            cfg, 4, 64, seed=0, rows=step.rows)), "cpu",
            compute_dtype(state))
        state, metrics = step(state, batch_)
        assert math.isfinite(float(metrics["loss"]))
        assert [tuple(x.shape) for x in tree_leaves(state["params"])] == before
