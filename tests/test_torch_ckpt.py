"""The port's checkpoint module (``repro_torch.ckpt``) against the JAX
package's (``repro.ckpt``): the pricing functions are equal, a save and
restore is exact, and checkpoints cross between the packages both ways --
the same ``ckpt_%08d.npz`` + ``.json`` layout, the leaves in JAX's
sorted-key order, bfloat16 widened to float32 in the file."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.ckpt import checkpoint as jcp
from repro.configs import registry as jax_registry
from repro.models import init_params as jax_init_params
from repro_torch import ckpt
from repro_torch.ckpt import checkpoint as tcp
from repro_torch.configs import registry
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as train_main
from repro_torch.models import init_params

ARCHS = sorted(jax_registry.ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_pricing_matches_jax(arch):
    """state_bytes (full and LoRA), lora_state_bytes, migration_seconds,
    checkpoint_seconds and the KV handoff's bytes and seconds: equal."""
    jc, tc = jax_registry.get_arch(arch), registry.get_arch(arch)
    assert tcp.CKPT_BYTES_PER_PARAM == jcp.CKPT_BYTES_PER_PARAM
    for rank in (0, 8, 64):
        assert tcp.state_bytes(tc, rank) == jcp.state_bytes(jc, rank)
        for bw in (16 * 2 ** 30, 1e9):
            assert tcp.migration_seconds(tc, bw, rank) == \
                jcp.migration_seconds(jc, bw, rank)
            assert tcp.checkpoint_seconds(tc, bw, rank) == \
                jcp.checkpoint_seconds(jc, bw, rank)
        if rank:
            assert tcp.lora_state_bytes(tc, rank) == jcp.lora_state_bytes(jc, rank)
    for batch, cache_len in ((1, 12), (8, 544), (4, 32768)):
        assert tcp.kv_handoff_bytes(tc, batch, cache_len) == \
            jcp.kv_handoff_bytes(jc, batch, cache_len)
        assert tcp.kv_handoff_seconds(tc, batch, cache_len) == \
            jcp.kv_handoff_seconds(jc, batch, cache_len)


def _tree(seed):
    rng = np.random.default_rng(seed)

    def leaf(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return {"b": {"z": leaf((3, 5), torch.bfloat16), "a": leaf((7,), torch.float32)},
            "a": leaf((2, 2, 4), torch.bfloat16), "c": leaf((), torch.float32)}


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_round_trip_is_exact(tmp_path):
    """float32 and bfloat16 leaves (bfloat16 through float32, which is
    exact) come back bit for bit, in the dtypes of ``like``; the manifest
    is the JAX package's."""
    tree = _tree(0)
    fname = ckpt.save(str(tmp_path), 7, tree)
    assert fname.endswith("ckpt_00000007.npz")
    like = {"a": torch.zeros(2, 2, 4, dtype=torch.bfloat16),
            "b": {"a": torch.zeros(7), "z": torch.zeros(3, 5, dtype=torch.bfloat16)},
            "c": torch.zeros(())}
    assert _equal(ckpt.restore(str(tmp_path), 7, like), tree)
    manifest = json.loads((tmp_path / "ckpt_00000007.json").read_text())
    _, treedef = jax.tree_util.tree_flatten(
        jax.tree.map(lambda t: np.zeros(t.shape), tree))
    assert manifest == {"treedef": str(treedef), "n_leaves": 4, "step": 7}
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 7, {"a": like["a"]})
    like["b"]["a"] = torch.zeros(8)
    with pytest.raises(ValueError, match="b.a"):
        ckpt.restore(str(tmp_path), 7, like)


@functools.cache
def _jax_smoke_params(arch):
    """The JAX package's smoke-config parameters (immutable arrays, so one
    draw serves every test)."""
    cfg = jax_registry.smoke_config(arch)
    return cfg, jax_init_params(cfg, jax.random.PRNGKey(3))


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint that ``repro.ckpt.save`` wrote from the JAX package's
    gpt2-350m smoke parameters restores into the port equal to interop's
    conversion of the same parameters."""
    jcfg, jparams = _jax_smoke_params("gpt2-350m")
    jckpt.save(str(tmp_path), 5, jparams)
    cfg = registry.smoke_config("gpt2-350m")
    like = init_params(cfg, 0, device="cpu")
    got = ckpt.restore(str(tmp_path), 5, like)
    want = params_from_numpy(cfg, _numpy_tree(jparams), device="cpu")
    assert _equal(got, want)


def test_port_checkpoint_restores_into_jax(tmp_path):
    """The other way: the port saves interop's conversion,
    ``repro.ckpt.restore`` reads it back into the JAX tree equal to the
    original parameters."""
    jcfg, jparams = _jax_smoke_params("gpt2-350m")
    cfg = registry.smoke_config("gpt2-350m")
    ckpt.save(str(tmp_path), 2, params_from_numpy(cfg, _numpy_tree(jparams),
                                                  device="cpu"))
    back = jckpt.restore(str(tmp_path), 2, jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        assert a.dtype == b.dtype and np.array_equal(
            np.asarray(a.astype(jnp.float32)), np.asarray(b.astype(jnp.float32)))


def test_train_driver_ckpt_dir_writes_what_jax_reads(tmp_path, monkeypatch):
    """``launch.train --smoke --device cpu --ckpt-dir`` saves the trained
    parameters after the last step; ``repro.ckpt.restore`` reads them back
    equal to the run's own parameters (taken from the driver's ``train``
    call) in their dtypes."""
    runs = []
    real_train = train_main.train

    def keep(*args, **kwargs):
        runs.append(real_train(*args, **kwargs))
        return runs[-1]
    monkeypatch.setattr(train_main, "train", keep)
    train_main.main(["--arch", "gpt2-350m", "--smoke", "--device", "cpu",
                     "--steps", "12", "--batch", "2", "--seq", "32",
                     "--ckpt-dir", str(tmp_path)])
    assert ckpt.latest_step(str(tmp_path)) == jckpt.latest_step(str(tmp_path)) == 12
    params = runs[0]["state"]["params"]
    _, jparams = _jax_smoke_params("gpt2-350m")
    back = jax.tree_util.tree_leaves(jckpt.restore(str(tmp_path), 12, jparams))
    leaves = tcp._flatten(params)
    assert len(leaves) == len(back)
    for (path, leaf), got in zip(leaves, back):
        assert got.dtype == jnp.dtype(str(leaf.dtype)[6:]), path
        assert np.array_equal(np.asarray(got.astype(jnp.float32)),
                              leaf.detach().float().numpy()), path


def test_latest_step(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    assert ckpt.latest_step(str(tmp_path)) is None
    for step in (3, 12, 7):
        ckpt.save(str(tmp_path), step, _tree(step))
    (tmp_path / "ckpt_00000099.npz.tmp.npz").write_bytes(b"")
    (tmp_path / "notes.txt").write_text("x")
    assert ckpt.latest_step(str(tmp_path)) == jckpt.latest_step(str(tmp_path)) == 12
