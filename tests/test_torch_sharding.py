"""The port's sharding rules, activation resolution and input stand-ins
against the JAX package's, on every config (whole and smoke) and mesh:
the production meshes (16, 16) and (2, 16, 16) with a pod axis, and every
(d, t) plan of the memcheck combos.  Specs compare as ``tuple(P)``; the
JAX meshes are duplicated CPU devices for spec arithmetic only
(tests/test_sharding.py's ``fake_mesh``), the port's are {axis: size}
stand-ins.  Exact equality throughout: both sides do integer arithmetic on
the same shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import registry as jax_registry
from repro.configs.base import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.launch import inputs as jax_inputs
from repro.models import init_params as jax_init_params
from repro.parallel import act as jax_act
from repro.parallel import sharding as jax_sh
from repro.train import state_specs as jax_state_specs
from repro_torch.configs import (INPUT_SHAPES, TrainConfig, get_arch,
                                 shape_applicable, smoke_config)
from repro_torch.launch import inputs
from repro_torch.launch.memcheck import COMBOS
from repro_torch.models import param_shapes
from repro_torch.parallel import act
from repro_torch.parallel import sharding as sh
from repro_torch.train.train_loop import state_specs

ARCHS = sorted(jax_registry.ARCHS)
PLANS = sorted({(d, t) for _, _, _, d, t in COMBOS})
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          **{f"plan{d}x{t}": ((d, t), ("data", "model")) for d, t in PLANS}}
_JAX_MESHES = {}
_JAX_SHAPES = {}


def fake_mesh(shape, axes):
    """An abstract mesh over fake devices for spec computation only."""
    n = int(np.prod(shape))
    devs = np.array(jax.devices() * (n // len(jax.devices()) + 1))[:n]
    return Mesh(devs.reshape(shape), axes)


def meshes(name):
    """(JAX mesh, the port's {axis: size})."""
    shape, axes = MESHES[name]
    if name not in _JAX_MESHES:
        _JAX_MESHES[name] = fake_mesh(shape, axes)
    return _JAX_MESHES[name], dict(zip(axes, shape))


def configs(arch, smoke):
    if smoke:
        return jax_registry.smoke_config(arch), smoke_config(arch)
    return jax_registry.get_arch(arch), get_arch(arch)


def jax_param_shapes(cfg):
    if cfg.name not in _JAX_SHAPES:
        _JAX_SHAPES[cfg.name] = jax.eval_shape(
            lambda k: jax_init_params(cfg, k),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
    return _JAX_SHAPES[cfg.name]


def as_tuples(tree):
    """A JAX spec or sharding tree as nested dicts of tuples."""
    def conv(x):
        return tuple(x.spec if isinstance(x, NamedSharding) else x)
    return jax.tree.map(conv, tree, is_leaf=lambda x: isinstance(
        x, (P, NamedSharding)))


def structs(tree):
    """{path: (shape, dtype name)} of a tree of ShapeDtypeStructs or
    tensors."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    walk(tree, ())
    return out


SPEC_CASES = [(a, s, m) for a in ARCHS for s in (False, True) for m in MESHES]


@pytest.mark.parametrize("arch,smoke,mesh_name", SPEC_CASES,
                         ids=[f"{a}-{'smoke' if s else 'whole'}-{m}"
                              for a, s, m in SPEC_CASES])
def test_specs_match_jax(arch, smoke, mesh_name):
    jcfg, cfg = configs(arch, smoke)
    jmesh, mesh = meshes(mesh_name)
    jshapes, shapes = jax_param_shapes(jcfg), param_shapes(cfg)
    for zero_data in (False, True):
        assert sh.param_specs(cfg, shapes, mesh, zero_data=zero_data) == \
            as_tuples(jax_sh.param_specs(jcfg, jshapes, jmesh,
                                         zero_data=zero_data))
    for zero in (0, 1, 3):
        want = as_tuples(jax_state_specs(jcfg, JaxTrainConfig(zero=zero),
                                         jmesh, {"params": jshapes}))
        got = state_specs(cfg, TrainConfig(zero=zero), mesh, shapes)
        assert got == want
    for name, shape in INPUT_SHAPES.items():
        jshape = JAX_INPUT_SHAPES[name]
        assert sh.batch_specs(cfg, shape, mesh) == \
            as_tuples(jax_sh.batch_specs(jcfg, jshape, jmesh))
        assert sh.cache_specs(cfg, shape, mesh) == \
            as_tuples(jax_sh.cache_specs(jcfg, jshape, jmesh))
        assert sh.prefill_cache_specs(cfg, shape, mesh) == \
            as_tuples(jax_sh.prefill_cache_specs(jcfg, jshape, jmesh))


@pytest.mark.parametrize("arch,smoke,mesh_name", SPEC_CASES,
                         ids=[f"{a}-{'smoke' if s else 'whole'}-{m}"
                              for a, s, m in SPEC_CASES])
def test_activation_resolution_matches_jax(arch, smoke, mesh_name):
    jcfg, cfg = configs(arch, smoke)
    jmesh, mesh = meshes(mesh_name)
    with jax_act.activation_sharding(jmesh, jcfg):
        want = jax_act._CTX.ctx[1]
    assert act.resolve(mesh, cfg) == want


def test_enforce_divisibility_drops_bad_axes():
    mesh = {"data": 16, "model": 16}
    assert sh.enforce_divisibility(("model", None), (24, 64), mesh) == \
        (None, None)
    assert sh.enforce_divisibility(("model", None), (32, 64), mesh) == \
        ("model", None)
    jmesh, _ = meshes("pod2x16x16")
    pod = {"pod": 2, "data": 16, "model": 16}
    rng = np.random.default_rng(0)
    for _ in range(200):
        shape = tuple(int(x) for x in rng.choice([1, 2, 3, 16, 24, 32, 48,
                                                  512, 509], size=3))
        axes = [None, "model", "data", ("pod", "data")]
        spec = tuple(axes[i] for i in rng.integers(0, len(axes), size=3))
        assert sh.enforce_divisibility(spec, shape, pod) == \
            tuple(jax_sh.enforce_divisibility(P(*spec), shape, jmesh))


def test_constrain_checks_local_shapes():
    cfg = smoke_config("llama3.2-3b")          # 8 query heads on 4 KV heads
    mesh = {"data": 2, "model": 2}
    x = torch.zeros(3, 5, 4, 32)
    assert act.constrain(x, (3, 5, 8, 32), "batch", None, "heads") is x
    with act.activation_sharding(mesh, cfg):
        assert act.constrain(x, (3, 5, 8, 32), "batch", None, "heads") is x
        assert act.constrain(torch.zeros(2, 5, 4, 32), (4, 5, 8, 32),
                             "batch", None, "heads").shape[0] == 2
        with pytest.raises(ValueError):
            act.constrain(x, (3, 5, 4, 32), None, None, "heads")


INPUT_CASES = [(a, n) for a in ARCHS for n in INPUT_SHAPES
               if shape_applicable(a, n)]


@pytest.mark.parametrize("arch,shape_name", INPUT_CASES,
                         ids=[f"{a}-{n}" for a, n in INPUT_CASES])
def test_inputs_match_jax(arch, shape_name):
    jcfg, cfg = configs(arch, False)
    jmesh, mesh = meshes("16x16")
    shape, jshape = INPUT_SHAPES[shape_name], JAX_INPUT_SHAPES[shape_name]
    tc = inputs.default_train_config(cfg, shape)
    assert tc == TrainConfig(**vars(jax_inputs.default_train_config(jcfg,
                                                                    jshape)))
    if shape.kind == "train":
        got, got_specs = inputs.train_inputs(cfg, shape, mesh, tc)
        want, want_sh = jax_inputs.train_inputs(jcfg, jshape, jmesh,
                                                JaxTrainConfig(**vars(tc)))
    elif shape.kind == "prefill":
        got, got_specs = inputs.prefill_inputs(cfg, shape, mesh)
        want, want_sh = jax_inputs.prefill_inputs(jcfg, jshape, jmesh)
    else:
        got, got_specs = inputs.decode_inputs(cfg, shape, mesh)
        want, want_sh = jax_inputs.decode_inputs(jcfg, jshape, jmesh)
    assert structs(got) == structs(want)
    for x in jax.tree.leaves(got):
        assert x.device.type == "meta"
    assert list(got_specs) == list(as_tuples(want_sh))
