"""The port's MoE FFN against the JAX package's ``moe_ffn`` on the CPU, in
float32: the output and the Switch aux loss on deepseek-v2's smoke config
(SwiGLU, one shared expert), without shared experts and with GELU experts,
and a router biased towards one expert so that capacity drops happen,
where the slots each (token, expert) pair lands in must be equal exactly.

Layer parameters come from the JAX package's ``init_moe`` cast to float32
(the router is float32 on both sides already); inputs are drawn with numpy
from a fixed seed.  Tolerance 1e-5: the same products summed in other
orders, and the port combines a token's expert outputs in one float32 sum
where JAX scatter-adds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import moe as jax_moe
from repro_torch.configs import smoke_config
from repro_torch.models import moe

ARCH = "deepseek-v2-236b"
TOL = dict(atol=1e-5, rtol=1e-5)
VARIANTS = {"smoke": {}, "no_shared": {"num_shared_experts": 0},
            "gelu": {"mlp_variant": "gelu"}}


def _pair(variant, seed=0):
    jcfg = jax_smoke_config(ARCH).scaled(**VARIANTS[variant])
    cfg = smoke_config(ARCH).scaled(**VARIANTS[variant])
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_moe.init_moe(jcfg, jax.random.PRNGKey(seed)))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        moe.moe_param_shapes(cfg)
    return jcfg, jp, cfg, p


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _capture(monkeypatch, module):
    """Record every ``xg`` (b, E, C, d) the module's expert FFN is given:
    the token rows gathered into each expert's capacity slots."""
    seen = []
    inner = module._expert_ffn

    def spy(cfg, p, xg):
        seen.append(np.array(xg.numpy() if isinstance(xg, torch.Tensor)
                             else xg))
        return inner(cfg, p, xg)

    monkeypatch.setattr(module, "_expert_ffn", spy)
    return seen


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_ffn_matches_jax(variant):
    jcfg, jp, cfg, p = _pair(variant)
    x = _x(cfg, 2, 24, seed=1)
    jout, jaux = jax_moe.moe_ffn(jcfg, jp, jnp.asarray(x))
    out, aux = moe.moe_ffn(cfg, p, torch.from_numpy(x))
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


def test_capacity_drops_keep_the_same_slots(monkeypatch):
    """Every token leans to expert 0 (a shared direction u in the inputs
    and in the router's column 0), so expert 0 gets all 24 tokens of a row
    against a capacity of 16: 8 entries a row are dropped, and which ones
    follows the stable sort.  The gathered slot inputs are equal exactly."""
    jcfg, jp, cfg, p = _pair("smoke", seed=2)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(cfg.d_model).astype(np.float32)
    u /= np.linalg.norm(u)
    x = _x(cfg, 2, 24, seed=4) + 4.0 * u
    router = np.array(jp["router"])
    router[:, 0] += 3.0 * u
    jp = dict(jp, router=jnp.asarray(router))
    p = dict(p, router=torch.from_numpy(router))
    C = moe.moe_capacity(24, cfg.num_experts, cfg.top_k)
    assert C == jax_moe.moe_capacity(24, cfg.num_experts, cfg.top_k) == 16

    seen_jax = _capture(monkeypatch, jax_moe)
    seen_port = _capture(monkeypatch, moe)
    jout, jaux = jax_moe.moe_ffn(jcfg, jp, jnp.asarray(x))
    out, aux = moe.moe_ffn(cfg, p, torch.from_numpy(x))
    (xg_jax,), (xg_port,) = seen_jax, seen_port
    assert xg_port.shape == xg_jax.shape == (2, cfg.num_experts, C,
                                             cfg.d_model)
    assert np.array_equal(xg_port, xg_jax)
    kept = np.abs(xg_port).sum(-1) > 0                      # (b, E, C)
    assert kept[:, 0].all()                                 # expert 0 is full
    assert kept.sum() < 2 * 24 * cfg.top_k                  # entries dropped
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("tokens", [1, 24, 512, 4096])
def test_moe_capacity_matches_jax(tokens):
    for E, k in ((4, 2), (160, 6)):
        assert moe.moe_capacity(tokens, E, k) == \
            jax_moe.moe_capacity(tokens, E, k)
