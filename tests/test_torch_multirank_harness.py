"""What the multi-rank test files share: the sizes, batches and tolerances of
the sharded step against the single-process one, the ``gloo`` spawn and its
results on disk, the shard-shape check, the JAX package's own sharded
step run in a subprocess on 4 host devices, and a float32 serving run
with the JAX package's sharded prefill and decode step beside it.  It
holds no test itself.

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
from repro_torch.serve import prefill, prompt_batch, serve_step
from repro_torch.serve.engine import _argmax
from repro_torch.train.optimizer import tree_leaves, tree_map
from repro_torch.train.train_loop import make_train_state

# microbatch 2: half the microbatches of 1, so half the collectives, which
# set the multi-rank files' time when the machine is loaded
B, S, MB, STEPS = 8, 64, 2, 4
GRAD_TOL, GNORM_RTOL, LOSS_TOL = 1e-5, 1e-5, 2e-2


def train_config(zero, microbatch=MB):
    return TrainConfig(global_batch=B, seq_len=S, microbatch=microbatch,
                       steps=STEPS, warmup_steps=1, zero=zero)


def batches(cfg, rows=None):
    """STEPS batches of SyntheticTokens(seed=3): the global batch, or a
    data rank's ``rows`` of it (a sharded step's ``step.rows``)."""
    data = SyntheticTokens(cfg, B, S, seed=3, rows=rows)
    return [to_device(next(data), "cpu", torch.float32) for _ in range(STEPS)]


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


def serve_run(cfg, params, prompt, cache_len, decodes, par=None, feed=None):
    """The serving path: prefill, then ``decodes`` decode steps on the
    greedy tokens, or on ``feed``'s (b, decodes) if given; with ``par``
    one rank's on its rows of the prompt.  {"logits{i}", the
    "prefill/..", "step1/.." and "decode/.." (after the last step) cache
    leaves, "tokens" (the greedy ones)} as numpy arrays."""
    def np_(t):
        return t.float().numpy().copy()

    out = {}
    logits, cache = prefill(cfg, params, prompt_batch(cfg, params, prompt),
                            cache_len, par)
    out["logits0"] = np_(logits)
    tok = _argmax(logits, par)
    toks = [tok]
    tags = {0: "prefill", 1: "step1", decodes: "decode"}
    for i in range(decodes + 1):
        if i in tags:
            out.update({f"{tags[i]}/{sub}/{name}": np_(t)
                        for sub, leaves in cache.items()
                        for name, t in leaves.items()})
        if i == decodes:
            break
        logits, cache = serve_step(cfg, params,
                                   tok if feed is None else feed[:, i:i + 1],
                                   cache,
                                   prompt.shape[1] + cfg.num_modal_tokens + i,
                                   par)
        out[f"logits{i + 1}"] = np_(logits)
        tok = _argmax(logits, par)
        toks.append(tok)
    out["tokens"] = torch.cat(toks, dim=1).numpy()
    return out


def close(got, want, tol):
    """(ok, the largest error relative to max |want|)."""
    assert got.shape == want.shape
    err = np.abs(got - want) / max(np.abs(want).max(), 1e-30)
    return err.max() <= tol, err.max()


# The JAX package's prefill, with its caches on prefill_cache_specs, and
# one serve_step on cache_specs, on 4 host devices, for each job of a
# JSON list (the arch's smoke config with the job's fields replaced, its
# mesh, batch, prompt and cache lengths), from the port's float32
# parameters and the same prompt and first token: each device's
# addressable shard of every cache leaf and of the logits, keyed by its
# mesh coordinates.
JAX_SERVE_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeConfig
from repro.configs.registry import smoke_config
from repro.models import init_params
from repro.parallel import sharding as sh
from repro.parallel.act import activation_sharding
from repro.serve.engine import prefill, serve_step

jobs = json.loads(sys.argv[1])
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
auto = getattr(jax.sharding, "AxisType", None)
for job in jobs:
    cfg = dataclasses.replace(smoke_config(job["arch"]), **job["fields"])
    shape = tuple(job["mesh"])
    kw = {} if auto is None else {"axis_types": (auto.Auto,) * len(shape)}
    mesh = jax.make_mesh(shape, AXES[len(shape)],
                         devices=jax.devices()[:int(np.prod(shape))], **kw)
    arrays = np.load(job["params"])
    struct = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    leaves, treedef = jax.tree_util.tree_flatten(struct)
    params = treedef.unflatten([jnp.asarray(arrays[f"arr_{i}"])
                                for i in range(len(leaves))])
    # the weights on the plan's param specs, over the data axes too for
    # the serving weights split over data (decode_inputs' rule)
    p_spec = sh.param_specs(cfg, struct, mesh, zero_data=job["zero_data"])
    params = jax.device_put(params, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), p_spec,
        is_leaf=lambda x: isinstance(x, P)))
    B, L = job["batch"], job["cache_len"]
    sc = ShapeConfig("serve", L, B, "decode", cache_len=L)
    batch = {"tokens": jnp.asarray(np.load(job["prompt"]), jnp.int32)}

    def shard(tree, specs):
        return {j: {k: NamedSharding(mesh, sh.enforce_divisibility(
            specs[j][k], tuple(leaf.shape), mesh)) for k, leaf in sub.items()}
            for j, sub in tree.items()}

    def prefill_fn(params, batch):
        with activation_sharding(mesh, cfg):
            return prefill(cfg, params, batch, L)

    out_sds = jax.eval_shape(prefill_fn, params, batch)
    c_sh = shard(out_sds[1], sh.prefill_cache_specs(cfg, sc, mesh))
    logits, cache = jax.jit(prefill_fn, out_shardings=(
        NamedSharding(mesh, P()), c_sh))(params, batch)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)

    def decode_fn(params, tokens, cache, pos):
        with activation_sharding(mesh, cfg):
            return serve_step(cfg, params, tokens, cache, pos)

    d_sh = shard(cache, sh.cache_specs(cfg, sc, mesh))
    logits2, cache2 = jax.jit(decode_fn, in_shardings=(None, None, d_sh, None),
                              out_shardings=(NamedSharding(mesh, P()), d_sh))(
        params, tok, cache, jnp.int32(batch["tokens"].shape[1]))
    res = {"logits0": np.asarray(logits, np.float32),
           "logits1": np.asarray(logits2, np.float32),
           "tokens": np.asarray(tok)}
    for tag, tree in (("prefill", cache), ("step1", cache2)):
        for j, sub in tree.items():
            for k, arr in sub.items():
                for s in arr.addressable_shards:
                    at = tuple(int(c) for c in
                               np.argwhere(mesh.devices == s.device)[0])
                    res[f"{tag}/{j}/{k}@{at}"] = np.asarray(s.data, np.float32)
    np.savez(job["out"], **res)
print("done")
"""


def start_jax_serve(tmp, jobs):
    """Start the JAX package's sharded prefill and one decode step on 4
    host devices (``JAX_SERVE_SCRIPT``) for ``jobs``: dicts of ``name``,
    ``arch``, ``fields`` (replaced in its smoke config), ``mesh``,
    ``batch``, ``cache_len``, ``params`` (the port's float32 tree),
    ``prompt`` and optionally ``zero_data`` (the serving weights split
    over data too; default False); job ``name``'s results go to
    ``jax-{name}.npz`` in ``tmp``.  Wait for it with
    ``proc.communicate()``."""
    pytest.importorskip("jax")
    sent = []
    for job in jobs:
        base = os.path.join(str(tmp), f"jax-{job['name']}")
        np.savez(base + "-params.npz",
                 *(p.numpy() for p in tree_leaves(job["params"])))
        np.save(base + "-prompt.npy", job["prompt"].numpy())
        sent.append({"arch": job["arch"], "fields": job["fields"],
                     "mesh": list(job["mesh"]), "batch": job["batch"],
                     "cache_len": job["cache_len"],
                     "zero_data": job.get("zero_data", False),
                     "params": base + "-params.npz",
                     "prompt": base + "-prompt.npy", "out": base + ".npz"})
    script = os.path.join(str(tmp), "jax_serve.py")
    with open(script, "w") as f:
        f.write(JAX_SERVE_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, script, json.dumps(sent)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
