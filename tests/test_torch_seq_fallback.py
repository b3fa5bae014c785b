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

from repro_torch.configs import TrainConfig, get_arch, smoke_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.data import SyntheticTokens
from repro_torch.launch.inputs import default_train_config
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.launch.train import to_device
from repro_torch.models import param_shapes
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from repro_torch.train.optimizer import tree_leaves, tree_map
from repro_torch.train.train_loop import (accumulate_grads, build_train_step,
                                          check_sharded_supported,
                                          make_local_state, make_train_state,
                                          resolve_microbatches, state_specs)

WORLD = 4
# (name, arch, replaced config fields, d, t, zero)
CASES = [("starcoder2-3b", "starcoder2-3b", {}, 1, 4, 0),
         ("starcoder2-3b", "starcoder2-3b", {}, 1, 4, 1),
         ("starcoder2-3b", "starcoder2-3b", {}, 1, 4, 3),
         ("mixtral-kv2", "mixtral-8x22b", dict(num_kv_heads=2), 1, 4, 1),
         ("starcoder2-kv1", "starcoder2-3b", dict(num_kv_heads=1), 2, 2, 1),
         ("starcoder2-kv1", "starcoder2-3b", dict(num_kv_heads=1), 2, 2, 3)]
B, S, MB, STEPS = 8, 64, 2, 4
GRAD_TOL, GNORM_RTOL, LOSS_TOL = 1e-5, 1e-5, 2e-2
# the GQA configs of the assigned set whose head counts do not divide t = 16
FALLBACK_ARCHS = ["starcoder2-3b", "starcoder2-7b", "stablelm-12b",
                  "mixtral-8x22b", "jamba-1.5-large-398b", "llama3.2-3b",
                  "llava-next-34b", "musicgen-medium"]


def config(name):
    arch, fields = next((a, f) for n, a, f, *_ in CASES if n == name)
    return dataclasses.replace(smoke_config(arch), **fields)


def train_config(zero):
    return TrainConfig(global_batch=B, seq_len=S, microbatch=MB, steps=STEPS,
                       warmup_steps=1, zero=zero)


def batches(cfg):
    data = SyntheticTokens(cfg, B, S, seed=3)
    return [to_device(next(data), "cpu") for _ in range(STEPS)]


def as_fp32(state):
    state["params"] = tree_map(lambda p: p.float(), state["params"])
    return state


def _key(name, d, t, zero):
    return f"{name}-{d}x{t}-zero{zero}"


def _case(name, d, t, zero):
    cfg, tc = config(name), train_config(zero)
    mesh = make_plan_mesh(d, t, device_type="cpu")
    assert not sh.attn_head_sharded(cfg, t)
    specs = state_specs(cfg, tc, mesh, param_shapes(cfg))
    data = batches(cfg)
    step, _ = build_train_step(cfg, tc, B, S, mesh=mesh)

    state = as_fp32(make_local_state(cfg, tc, mesh, device="cpu"))
    acc, _ = step.accumulate(state["params"], data[0])
    o_specs = tree_leaves(specs["opt"]["master"])
    grads = [col.gather_leaf(g, s, mesh).numpy() for g, s in zip(acc, o_specs)]
    _, metrics = step(state, data[0])
    gnorm = float(metrics["grad_norm"])

    state = make_local_state(cfg, tc, mesh, device="cpu")
    bad = []
    for part, spec_tree in (("params", specs["params"]),
                            ("master", specs["opt"]["master"])):
        tree = state["params"] if part == "params" else \
            state["opt"]["master"]
        for leaf, spec, shape in zip(tree_leaves(tree), tree_leaves(spec_tree),
                                     tree_leaves(param_shapes(cfg))):
            if tuple(leaf.shape) != col.local_shape(shape, spec, mesh):
                bad.append(f"{part} {tuple(leaf.shape)} {spec}")
    losses = [float(step(state, batch)[1]["loss"]) for batch in data]
    return {"grads": grads, "gnorm": gnorm, "losses": losses, "bad": bad}


def _worker(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        out = {}
        for name, _, _, d, t, zero in CASES:
            res = _case(name, d, t, zero)
            key = _key(name, d, t, zero)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{key}.npz"), *res["grads"])
            out[key] = {k: res[k] for k in ("gnorm", "losses", "bad")}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# The JAX package's sharded step on a (1, 4) mesh of 4 host devices, from
# the port's starcoder2-3b smoke parameters (bf16, saved as float32, which
# is exact), on the same batches: its four losses.
JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import TrainConfig
from repro.configs.registry import smoke_config
from repro.data import SyntheticTokens
from repro.launch.mesh import make_plan_mesh
from repro.parallel.sharding import attn_head_sharded
from repro.train import build_train_step, init_opt_state, state_specs

params_npz, B, S, MB, steps = sys.argv[1], *map(int, sys.argv[2:6])
cfg = smoke_config("starcoder2-3b")
assert not attn_head_sharded(cfg, 4)
tc = TrainConfig(global_batch=B, seq_len=S, microbatch=MB, steps=steps,
                 warmup_steps=1, zero=1)
mesh = make_plan_mesh(1, 4)
arrays = np.load(params_npz)
from repro.models import init_params
struct = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
leaves, treedef = jax.tree_util.tree_flatten(struct)
params = treedef.unflatten([jnp.asarray(arrays[f"arr_{i}"]).astype(leaf.dtype)
                            for i, leaf in enumerate(leaves)])
state = {"params": params, "opt": init_opt_state(params),
         "step": jnp.zeros((), jnp.int32)}
sspec = state_specs(cfg, tc, mesh, state)
state = jax.device_put(state, jax.tree.map(
    lambda s: NamedSharding(mesh, s), sspec, is_leaf=lambda x: isinstance(x, P)))
step_fn, _ = build_train_step(cfg, tc, mesh, B, S)
step = jax.jit(step_fn, donate_argnums=(0,))
data = iter(SyntheticTokens(cfg, B, S, seed=3))
losses = []
for _ in range(steps):
    state, m = step(state, {k: jnp.asarray(v) for k, v in next(data).items()})
    losses.append(float(m["loss"]))
print(json.dumps(losses))
"""


def _start_jax(tmp):
    """Start the JAX package's sharded run in a subprocess (the XLA device
    count is fixed at JAX's first use); it runs beside the gloo spawn."""
    pytest.importorskip("jax")
    cfg = smoke_config("starcoder2-3b")
    params = make_train_state(cfg, train_config(1), device="cpu")["params"]
    np.savez(tmp / "params.npz", *(p.float().numpy()
                                   for p in tree_leaves(params)))
    (tmp / "jax_run.py").write_text(JAX_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, str(tmp / "jax_run.py"), str(tmp / "params.npz"),
         str(B), str(S), str(MB), str(STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here as in the ranks: small products, and the
    other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(out_dir, [each rank's results], the JAX run's losses): the JAX
    subprocess and the one spawn of 4 ranks run at once."""
    tmp = tmp_path_factory.mktemp("seq_fallback")
    jax_run = _start_jax(tmp)
    try:
        mp.spawn(_worker, args=(_free_port(), str(tmp)), nprocs=WORLD,
                 join=True)
        out, err = jax_run.communicate(timeout=600)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.communicate()
    assert jax_run.returncode == 0, err[-3000:]
    res = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            res.append(json.load(f))
    return tmp, res, json.loads(out.strip().splitlines()[-1])


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
    """deepseek-v2 smoke's 8 MLA heads on a model axis of 16."""
    cfg = smoke_config("deepseek-v2-236b")
    assert not sh.attn_head_sharded(cfg, 16)
    with pytest.raises(NotImplementedError, match="item 10"):
        check_sharded_supported(cfg, train_config(1),
                                {"data": 1, "model": 16})
