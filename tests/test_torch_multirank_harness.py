"""What the multi-rank test files share: the sizes, batches and tolerances of
the sharded step against the single-process one, the ``gloo`` spawn and its
results on disk, the shard-shape check, and the JAX package's own sharded
step run in a subprocess on 4 host devices.  It holds no test itself.

Tolerances and their reasons:

* params cast to float32, step 1's accumulated gradients, gathered from
  the ranks' optimizer shards: max |d| <= 1e-5 max |g| per leaf, and the
  grad norm within 1e-5 relative -- the ranks sum the same products in
  other orders (over the data axes, over the model axis's heads and
  columns).
* bf16, four steps: losses within 2e-2, the JAX package's own multi-device
  tolerance (tests/test_multidevice.py:77), and the loss falls; against
  the JAX package's sharded step the same 2e-2 holds the losses and step
  1's bf16 grad norm.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import TrainConfig, smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch.train import to_device
from repro_torch.parallel import collectives as col
from repro_torch.train.optimizer import tree_leaves, tree_map
from repro_torch.train.train_loop import make_train_state

# microbatch 2: half the microbatches of 1, so half the collectives, which
# set the multi-rank files' time when the machine is loaded
B, S, MB, STEPS = 8, 64, 2, 4
GRAD_TOL, GNORM_RTOL, LOSS_TOL = 1e-5, 1e-5, 2e-2


def train_config(zero, microbatch=MB):
    return TrainConfig(global_batch=B, seq_len=S, microbatch=microbatch,
                       steps=STEPS, warmup_steps=1, zero=zero)


def batches(cfg):
    data = SyntheticTokens(cfg, B, S, seed=3)
    return [to_device(next(data), "cpu") for _ in range(STEPS)]


def as_fp32(state):
    state["params"] = tree_map(lambda p: p.float(), state["params"])
    return state


def paths(tree, prefix=()):
    """The leaves' "a/b/c" paths, in ``tree_leaves``'s order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from paths(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,))


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def bad_shards(state, specs, shapes, mesh):
    """The params and master leaves of a rank's state whose shapes differ
    from their specs' shards of the whole ``shapes``."""
    bad = []
    for part, tree, spec_tree in (
            ("params", state["params"], specs["params"]),
            ("master", state["opt"]["master"], specs["opt"]["master"])):
        for name, leaf, spec, shape in zip(
                paths(tree), tree_leaves(tree), tree_leaves(spec_tree),
                tree_leaves(shapes)):
            if tuple(leaf.shape) != col.local_shape(shape, spec, mesh):
                bad.append(f"{part}/{name} {tuple(leaf.shape)} {spec}")
    return bad


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here as in the ranks: small products, and the
    other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank_main(rank, world, port, out_dir, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        out = work(rank, world, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(work, world, out_dir):
    """Start ``world`` gloo processes, each running ``work(rank, world,
    out_dir)`` (a module-level function) and writing its JSON result; not
    joined (``join_ranks``)."""
    return mp.spawn(_rank_main, args=(world, free_port(), str(out_dir), work),
                    nprocs=world, join=False)


def join_ranks(ctx, world, out_dir):
    """Wait for a spawn; each rank's result."""
    while not ctx.join():
        pass
    res = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


# The JAX package's sharded step on 4 host devices, once for each job of a
# JSON list: the arch's smoke config with the job's fields replaced, its
# mesh ((data, model) or (pod, data, model)) and ZeRO stage, from the
# job's parameters (the port's bf16 params saved as float32, exact), on
# SyntheticTokens(seed=3).  Prints one JSON list: each job's losses and
# step 1's grad norm.
JAX_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import TrainConfig
from repro.configs.registry import smoke_config
from repro.data import SyntheticTokens
from repro.models import init_params
from repro.train import build_train_step, init_opt_state, state_specs

jobs, B, S, MB, steps = json.loads(sys.argv[1]), *map(int, sys.argv[2:6])
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
auto = getattr(jax.sharding, "AxisType", None)
out = []
for job in jobs:
    cfg = dataclasses.replace(smoke_config(job["arch"]), **job["fields"])
    tc = TrainConfig(global_batch=B, seq_len=S, microbatch=MB, steps=steps,
                     warmup_steps=1, zero=job["zero"])
    shape = tuple(job["mesh"])
    kw = {} if auto is None else {"axis_types": (auto.Auto,) * len(shape)}
    mesh = jax.make_mesh(shape, AXES[len(shape)],
                         devices=jax.devices()[:int(np.prod(shape))], **kw)
    arrays = np.load(job["params"])
    struct = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    leaves, treedef = jax.tree_util.tree_flatten(struct)
    params = treedef.unflatten([jnp.asarray(arrays[f"arr_{i}"]).astype(l.dtype)
                                for i, l in enumerate(leaves)])
    state = {"params": params, "opt": init_opt_state(params),
             "step": jnp.zeros((), jnp.int32)}
    spec = state_specs(cfg, tc, mesh, state)
    state = jax.device_put(state, jax.tree.map(
        lambda s: NamedSharding(mesh, s), spec,
        is_leaf=lambda x: isinstance(x, P)))
    step = build_train_step(cfg, tc, mesh, B, S, jit=True)[0]
    data = iter(SyntheticTokens(cfg, B, S, seed=3))
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in next(data).items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out.append({"losses": losses, "grad_norm": norms[0]})
print(json.dumps(out))
"""


def start_jax(tmp, jobs):
    """Start the JAX package's sharded steps for ``jobs`` -- dicts of
    ``arch``, ``fields`` (replaced in its smoke config), ``mesh`` and
    ``zero`` -- in a subprocess (the XLA device count is fixed at JAX's
    first use), from the port's fresh bf16 params of the same config; it
    runs beside a spawn (``jax_results``)."""
    pytest.importorskip("jax")
    sent = []
    for i, job in enumerate(jobs):
        cfg = dataclasses.replace(smoke_config(job["arch"]), **job["fields"])
        params = make_train_state(cfg, train_config(job["zero"]),
                                  device="cpu")["params"]
        path = os.path.join(str(tmp), f"jax_params{i}.npz")
        np.savez(path, *(p.float().numpy() for p in tree_leaves(params)))
        sent.append({**job, "mesh": list(job["mesh"]), "params": path})
    script = os.path.join(str(tmp), "jax_run.py")
    with open(script, "w") as f:
        f.write(JAX_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, script, json.dumps(sent), str(B), str(S), str(MB),
         str(STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def jax_results(proc, timeout=600):
    """Each job's {"losses", "grad_norm"} from ``start_jax``'s run."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])
