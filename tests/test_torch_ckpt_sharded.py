"""Checkpoints of a sharded state: every rank of a (d, t) plan gathers the
parameters from the shards (a collective) and rank 0 writes
``ckpt.save``'s files.  Two ``gloo`` processes, at (1, 2) and (2, 1), in
one spawn:

* ``launch.train.save_checkpoint`` of the ranks' fp32 shards writes the
  files the one-process state's ``ckpt.save`` writes, bit for bit;
* the train driver with ``--ckpt-dir`` under the ``torchrun`` environment
  (its rank path sizes the plan as d = min(world, batch): batch 1 gives
  (1, 2), batch 2 gives (2, 1)) writes, after its last step, files that
  the JAX package's ``repro.ckpt.restore`` reads, in the one-process
  driver run's layout (tree, shapes, dtypes, step), and that cut to each
  rank's specs give that rank's final shards bit for bit.  (The values
  are not the one-process run's: the ranks sum their gradients in other
  orders, and Adam turns a near-zero gradient's sign flip into a step of
  about the learning rate.)
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro import ckpt as jckpt
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro_torch import ckpt
from repro_torch.configs import TrainConfig, smoke_config
from repro_torch.launch import train as train_driver
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.models import param_shapes
from repro_torch.parallel import collectives as col
from repro_torch.train.optimizer import tree_leaves, tree_map
from repro_torch.train.train_loop import (make_local_state, make_train_state,
                                          state_specs)
from test_torch_multirank_harness import free_port

ARCH = "starcoder2-3b"
PLANS = [(1, 2), (2, 1)]


def _args(batch, out):
    return ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "12",
            "--batch", str(batch), "--seq", "32", "--ckpt-dir", out]


def _tc():
    return TrainConfig(global_batch=2, seq_len=32, microbatch=1)


def _fp32(state):
    state["params"] = tree_map(lambda p: p.float(), state["params"])
    return state


def _worker(rank, ports, out_dir):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(ports[0]),
                      RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2")
    cfg = smoke_config(ARCH)
    dist.init_process_group("gloo")
    try:
        for d, t in PLANS:
            mesh = make_plan_mesh(d, t, device_type="cpu")
            state = _fp32(make_local_state(cfg, _tc(), mesh, device="cpu"))
            wrote = train_driver.save_checkpoint(
                os.path.join(out_dir, f"fp32_{d}x{t}"), 0, cfg, _tc(), state,
                mesh)
            assert wrote == (rank == 0)
    finally:
        dist.destroy_process_group()
    real_train, kept = train_driver.train, []

    def keep(*args, **kwargs):
        kept.append(real_train(*args, **kwargs))
        return kept[-1]
    train_driver.train = keep
    for (d, t), port in zip(PLANS, ports[1:]):
        os.environ["MASTER_PORT"] = str(port)
        train_driver.main(_args(1 if d == 1 else 2,
                                os.path.join(out_dir, f"driver_{d}x{t}")))
        # this rank's final shards, bf16 widened to float32 (exact)
        np.savez(os.path.join(out_dir, f"shards_{d}x{t}_rank{rank}.npz"),
                 *(p.detach().float().numpy()
                   for p in tree_leaves(kept[-1]["state"]["params"])))


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    """The 2-rank runs' files beside the one-process ones."""
    tmp = tmp_path_factory.mktemp("ckpt_sharded")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ports = [free_port() for _ in range(1 + len(PLANS))]
        mp.spawn(_worker, args=(ports, str(tmp)), nprocs=2, join=True)
        cfg = smoke_config(ARCH)
        ckpt.save(str(tmp / "fp32_one"), 0,
                  _fp32(make_train_state(cfg, _tc(), device="cpu"))["params"])
        env = {k: os.environ.pop(k) for k in ("WORLD_SIZE", "RANK")
               if k in os.environ}
        try:
            for batch in (1, 2):
                train_driver.main(_args(batch, str(tmp / f"driver_one_b{batch}")))
        finally:
            os.environ.update(env)
    finally:
        torch.set_num_threads(n)
    return tmp


def _files(path, step):
    with np.load(os.path.join(path, f"ckpt_{step:08d}.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(path, f"ckpt_{step:08d}.json")) as f:
        return arrays, json.load(f)


@pytest.mark.parametrize("d,t", PLANS)
def test_fp32_shards_save_bit_for_bit(out_dir, d, t):
    got, got_meta = _files(out_dir / f"fp32_{d}x{t}", 0)
    want, want_meta = _files(out_dir / "fp32_one", 0)
    assert got_meta == want_meta
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("d,t", PLANS)
def test_driver_ckpt_dir_under_torchrun(out_dir, d, t):
    """The 2-rank driver's files restore into the JAX tree as the
    one-process run's do, and each rank's final shards are cut from them
    bit for bit."""
    path = str(out_dir / f"driver_{d}x{t}")
    one = str(out_dir / f"driver_one_b{1 if d == 1 else 2}")
    assert ckpt.latest_step(path) == jckpt.latest_step(path) == 12
    assert _files(path, 12)[1] == _files(one, 12)[1]
    like = jax.eval_shape(lambda: jax_init_params(jax_smoke_config(ARCH),
                                                  jax.random.PRNGKey(0)))
    like = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), like)
    got = jax.tree_util.tree_leaves(jckpt.restore(path, 12, like))
    want = jax.tree_util.tree_leaves(jckpt.restore(one, 12, like))
    assert [(g.dtype, g.shape) for g in got] == \
        [(w.dtype, w.shape) for w in want]
    cfg = smoke_config(ARCH)
    mesh = {"data": d, "model": t}
    specs = tree_leaves(state_specs(cfg, _tc(), mesh,
                                    param_shapes(cfg))["params"])
    for rank in range(d * t):
        coords = {"data": rank // t, "model": rank % t}
        with np.load(out_dir / f"shards_{d}x{t}_rank{rank}.npz") as z:
            shards = [z[f"arr_{i}"] for i in range(len(z.files))]
        assert len(shards) == len(got) == len(specs)
        for g, spec, shard in zip(got, specs, shards):
            cut = col.shard_leaf(torch.from_numpy(np.asarray(g, np.float32)),
                                 spec, mesh, coords)
            assert np.array_equal(cut.numpy(), shard), spec
