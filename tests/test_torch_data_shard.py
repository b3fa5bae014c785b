"""Each data rank of the sharded train step is fed only its rows of the
global batch, and the modal embeddings reach the step at its compute
dtype.

The JAX package shards a training batch over ("pod", "data")
(``repro/parallel/sharding.py`` ``batch_specs``) and its step reshapes it
into microbatches sharded over the same axes
(``repro/train/train_loop.py:100-104``).  Held here, at smoke sizes: the
port's row rule (``sharding.data_rows``) against that reshape's row order
computed with numpy; the port's ``SyntheticTokens`` rows against the JAX
pipeline's rows of the same indices; a sharded step handed the whole
batch refused; ``launch.train.train`` feeding a rank its rows; and a
dry-run llava rank whose entry holds its state and its shard's rows
alone, its modal stand-in in the feed's dtype.  The ``gloo`` holdings of
the sharded step against the single process and the JAX sharded step
are ``tests/test_torch_multirank*.py`` and the files beside them.
"""
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro_torch.configs import TrainConfig, smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch import dryrun
from repro_torch.launch import train as train_main
from repro_torch.launch.memcheck import fake_world
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.launch.op_analysis import alloc_bytes
from repro_torch.launch.train import compute_dtype, to_device
from repro_torch.parallel import sharding as sh
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import build_train_step, make_local_state

# the data axes of a mesh: ("data",) or ("pod", "data"), pod-major
MESHES = [{"data": 1, "model": 2}, {"data": 2, "model": 1},
          {"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 1},
          {"pod": 2, "data": 1, "model": 2}]


def jax_reshape_rows(batch, n_micro, nd, r):
    """The global rows data rank r holds after the JAX step's
    ``reshape_micro``: (B, ...) becomes (n_micro, B / n_micro, ...), whose
    dim 1 is split over the data axes in nd contiguous blocks, pod-major
    (``P(None, ("pod", "data"))``), microbatch after microbatch."""
    y = np.arange(batch).reshape(n_micro, batch // n_micro)
    return np.split(y, nd, axis=1)[r].ravel().tolist()


@pytest.mark.parametrize("n_micro", [1, 2, 4])
@pytest.mark.parametrize("mesh", MESHES,
                         ids=["x".join(map(str, m.values())) for m in MESHES])
def test_data_rows_are_the_jax_reshapes(mesh, n_micro):
    nd = sh.n_data_shards(mesh)
    batch = 3 * n_micro * nd
    got = [sh.data_rows(batch, n_micro, mesh, r) for r in range(nd)]
    assert got == [jax_reshape_rows(batch, n_micro, nd, r) for r in range(nd)]
    assert sorted(sum(got, [])) == list(range(batch))
    if n_micro * nd > 1:
        with pytest.raises(ValueError, match="does not split"):
            sh.data_rows(batch + 1, n_micro, mesh, 0)
    with pytest.raises(ValueError, match="data rank"):
        sh.data_rows(batch, n_micro, mesh, nd)


@pytest.mark.parametrize("arch", ["llava-next-34b", "llama3.2-3b"])
def test_rank_rows_are_the_jax_pipelines_rows(arch):
    """Three batches of rank 1 of (2, 1) at two microbatches: each row the
    JAX pipeline's row of that index, the modal embeddings built for the
    rank's rows alone."""
    cfg = smoke_config(arch)
    rows = sh.data_rows(8, 2, {"data": 2, "model": 1}, 1)
    assert rows == [2, 3, 6, 7]
    ours = SyntheticTokens(cfg, 8, 64, seed=3, rows=rows)
    theirs = JaxSyntheticTokens(jax_smoke_config(arch), 8, 64, seed=3)
    for _ in range(3):
        got, want = next(ours), next(theirs)
        assert sorted(got) == sorted(want)
        for key in got:
            assert got[key].shape[0] == len(rows)
            np.testing.assert_array_equal(got[key], want[key][rows])


def _tc(batch, steps=1):
    return TrainConfig(global_batch=batch, seq_len=64, microbatch=1, zero=1,
                       steps=steps, warmup_steps=1)


def test_a_sharded_step_refuses_the_whole_batch():
    """Rank 0 of (2, 2) takes rows 0 and 2 of a batch of 4 (two
    microbatches); the whole batch, or any other row count, raises before
    anything runs.  The one-device step's rows are every row."""
    cfg, tc = smoke_config("llama3.2-3b"), _tc(4)
    assert build_train_step(cfg, tc, 4, 64)[0].rows == [0, 1, 2, 3]
    with fake_world(4, 0):
        mesh = make_plan_mesh(2, 2, device_type="cpu")
        state = make_local_state(cfg, tc, mesh, device="cpu")
        step, n_micro = build_train_step(cfg, tc, 4, 64, mesh=mesh)
        assert (n_micro, step.rows) == (2, [0, 2])
        data = SyntheticTokens(cfg, 4, 64, seed=0)
        whole = to_device(next(data), "cpu", compute_dtype(state))
        for batch in (whole, {k: v[:1] for k, v in whole.items()}):
            with pytest.raises(ValueError, match="step.rows"):
                step(state, batch)
            with pytest.raises(ValueError, match="step.rows"):
                step.accumulate(state["params"], batch)


def test_train_feeds_a_rank_its_rows(monkeypatch):
    """``launch.train.train`` as rank 1 of (2, 1) under the fake group:
    the batch it moves to the device is the rank's rows of the JAX
    pipeline's batch, the modal embeddings at the params' dtype."""
    cfg = smoke_config("llava-next-34b")
    fed = []

    def spy(raw, device, dtype):
        out = to_device(raw, device, dtype)
        fed.append((raw, out))
        return out

    monkeypatch.setattr(train_main, "to_device", spy)
    with fake_world(2, 1):
        mesh = make_plan_mesh(2, 1, device_type="cpu")
        train_main.train(cfg, _tc(4), device="cpu", mesh=mesh,
                         log=lambda line: None)
    (raw, moved), = fed
    want = next(JaxSyntheticTokens(jax_smoke_config("llava-next-34b"), 4, 64,
                                   seed=_tc(4).seed))
    rows = sh.data_rows(4, 2, mesh, 1)
    assert rows == [1, 3]
    for key in want:
        np.testing.assert_array_equal(raw[key], want[key][rows])
    assert moved["modal_embeds"].dtype == torch.bfloat16
    assert moved["tokens"].shape == (2, 64 - cfg.num_modal_tokens)


def test_dry_run_rank_entry_is_its_state_and_its_shard():
    """A smoke llava train step on (2, 2), 4 microbatches traced as 2: the
    entry holds the rank's state and its shard's rows of the global batch
    (4 of 8, over every microbatch), the modal stand-in in the dtype
    ``to_device`` feeds the card."""
    cfg, tc = smoke_config("llava-next-34b"), _tc(8)
    stats, row = dryrun.trace_train(cfg, tc, 1, 2, 2)
    assert row["n_micro"] == 4
    with fake_world(4):
        mesh = make_plan_mesh(2, 2, device_type="cpu")
        state = make_local_state(cfg, tc, mesh, device="meta",
                                 whole_leaves=False)
        dtype = compute_dtype(state)
    held = sum(alloc_bytes(t.numel() * t.element_size())
               for t in tree_leaves(state["params"])
               + tree_leaves(state["opt"]))
    shard = dryrun.train_batch(cfg, 4, 64, dtype)
    raw = next(SyntheticTokens(cfg, 8, 64, rows=[0, 1, 4, 5]))
    fed = to_device(raw, "cpu", dtype)
    assert {k: (t.dtype, tuple(t.shape)) for k, t in shard.items()} == \
        {k: (t.dtype, tuple(t.shape)) for k, t in fed.items()}
    assert shard["modal_embeds"].dtype == torch.bfloat16
    assert stats.entry_bytes == held + sum(
        alloc_bytes(t.numel() * t.element_size()) for t in shard.values())
