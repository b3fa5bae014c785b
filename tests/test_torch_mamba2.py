"""The port's Mamba2 mixer against the JAX package's, on the CPU: the gated
norm, the causal conv, the full-sequence forward with its conv and SSD
cache (prompts shorter than the conv window included), the decode step,
the init rules, and a ragged prompt length that the JAX package's CPU path
refuses, held there against JAX running the Pallas kernel in interpret
mode and against prefill + decode.

Inputs are drawn with numpy from a fixed seed; layer parameters come from
the JAX package's ``init_mamba2`` on the mamba2-130m smoke config, cast to
float32.  The layers are compared in float32 at 1e-4, absolute and
relative: two frameworks summing the same products in other orders (and
chunking the scan differently) differ by a few 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.kernels import dispatch as jax_dispatch
from repro.models import common as jax_common
from repro.models import mamba2 as jax_mamba2
from repro_torch.configs import smoke_config
from repro_torch.kernels import LAUNCHES
from repro_torch.models import init_params
from repro_torch.models.common import gated_rms_norm
from repro_torch.models.mamba2 import (_causal_conv, c_dot_state,
                                       mamba2_decode, mamba2_forward,
                                       mamba2_param_shapes)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's tests, restored after: the CPU
    ops here are small, and a pool of spinning threads per test process
    only crowds the other processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "mamba2-130m"
TOL = dict(atol=1e-4, rtol=1e-4)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def layer():
    """(jax cfg, jax layer params, port cfg, port layer params), float32."""
    jcfg = jax_smoke_config(ARCH)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_mamba2.init_mamba2(jcfg, jax.random.PRNGKey(4)))
    cfg = smoke_config(ARCH)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in p.items()} == mamba2_param_shapes(cfg)
    return jcfg, jp, cfg, p


def _x(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def test_smoke_config_has_the_jax_widths(layer):
    _, _, cfg, _ = layer
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.n_ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state) == (2, 256, 512, 16, 32, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, z = (rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
            for _ in range(2))
    scale = rng.standard_normal(64).astype(np.float32)
    jargs = [jnp.asarray(a).astype(dtype) for a in (x, z, scale)]
    want = jax_common.gated_rms_norm(*jargs, 1e-5)
    got = gated_rms_norm(*(torch.tensor(_f32(a)).to(getattr(torch, dtype))
                           for a in jargs), 1e-5)
    assert str(got.dtype).endswith(dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("s", [1, 2, 9])
def test_causal_conv_matches_jax(layer, s):
    _, _, cfg, _ = layer
    rng = np.random.default_rng(s)
    ch = cfg.d_inner + 2 * cfg.ssm_state
    xBC = rng.standard_normal((2, s, ch)).astype(np.float32)
    w = rng.standard_normal((cfg.ssm_conv, ch)).astype(np.float32)
    b = rng.standard_normal(ch).astype(np.float32)
    want = jax_mamba2._causal_conv(*(jnp.asarray(a) for a in (xBC, w, b)))
    got = _causal_conv(*(torch.from_numpy(a) for a in (xBC, w, b)))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


@pytest.mark.parametrize("s", [1, 2, 3, 12, 128])
def test_mamba2_forward_matches_jax(layer, s):
    """Prompts of 1 and 2 rows are shorter than the conv window's w - 1 = 3
    rows, so the conv cache is left-padded with zeros; 128 is one whole
    chunk of the JAX package's scan."""
    jcfg, jp, cfg, p = layer
    x = _x(cfg, 2, s)
    jout, jcache = jax_mamba2.mamba2_forward(jcfg, jp, jnp.asarray(x))
    out, cache = mamba2_forward(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(_f32(out), _f32(jout), **TOL)
    assert set(cache) == set(jcache) == {"conv", "ssd"}
    assert cache["ssd"].dtype == torch.float32
    assert tuple(cache["conv"].shape) == (2, cfg.ssm_conv - 1,
                                          cfg.d_inner + 2 * cfg.ssm_state)
    for name in cache:
        np.testing.assert_allclose(_f32(cache[name]), _f32(jcache[name]), **TOL)


@pytest.mark.parametrize("s", [1, 5])
def test_mamba2_decode_matches_jax(layer, s):
    """Prefill s rows, then 6 decode steps on both sides: outputs and both
    cache entries after every step."""
    jcfg, jp, cfg, p = layer
    x = _x(cfg, 2, s + 6, seed=1)
    _, jcache = jax_mamba2.mamba2_forward(jcfg, jp, jnp.asarray(x[:, :s]))
    _, cache = mamba2_forward(cfg, p, torch.from_numpy(x[:, :s]))
    for t in range(s, s + 6):
        jout, jcache = jax_mamba2.mamba2_decode(jcfg, jp,
                                                jnp.asarray(x[:, t:t + 1]),
                                                jcache)
        out, cache = mamba2_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]),
                                   cache)
        np.testing.assert_allclose(_f32(out), _f32(jout), **TOL)
        for name in cache:
            np.testing.assert_allclose(_f32(cache[name]), _f32(jcache[name]),
                                       **TOL)


def test_mamba2_forward_at_a_ragged_length_matches_the_pallas_path(layer):
    """s = 200 is not a multiple of the scan's 128-row chunk: the JAX
    package's CPU path asserts there (tests/test_torch_ssd.py), so the
    port's layer is held against the JAX layer with its SSD op forced to
    the Pallas kernel, run in interpret mode, which pads the tail."""
    jcfg, jp, cfg, p = layer
    x = _x(cfg, 1, 200, seed=2)
    with jax_dispatch.force("pallas"):
        jout, jcache = jax_mamba2.mamba2_forward(jcfg, jp, jnp.asarray(x))
    out, cache = mamba2_forward(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(_f32(out), _f32(jout), **TOL)
    for name in cache:
        np.testing.assert_allclose(_f32(cache[name]), _f32(jcache[name]), **TOL)


@pytest.mark.parametrize("s", [1, 2, 200])
def test_prefill_then_decode_equals_the_full_forward(layer, s):
    """The last row of a forward over s + 1 rows equals a prefill of s rows
    followed by one decode step, ragged s = 200 included."""
    _, _, cfg, p = layer
    x = torch.from_numpy(_x(cfg, 2, s + 1, seed=3))
    full, _ = mamba2_forward(cfg, p, x)
    _, cache = mamba2_forward(cfg, p, x[:, :s])
    step, _ = mamba2_decode(cfg, p, x[:, s:], cache)
    np.testing.assert_allclose(_f32(step), _f32(full[:, -1:]), **TOL)


@pytest.mark.parametrize("n", [16, 128])
def test_c_dot_state_is_batch_invariant(n):
    """The decode step's float32 C . state (the smoke and the full state
    width): each row alone gives the same bits as in a batch of 8, which
    the continuous batchers need to match per-request greedy; and it is
    the einsum it replaces, within float32 rounding."""
    rng = np.random.default_rng(9)
    C = torch.from_numpy(rng.standard_normal((8, n)).astype(np.float32))
    state = torch.from_numpy(rng.standard_normal((8, 24, 64, n)
                                                 ).astype(np.float32))
    eight = c_dot_state(C, state)
    one = torch.cat([c_dot_state(C[i:i + 1], state[i:i + 1]) for i in range(8)])
    assert eight.dtype == torch.float32 and tuple(eight.shape) == (8, 24, 64)
    assert torch.equal(one, eight)
    torch.testing.assert_close(eight, torch.einsum("bn,bhpn->bhp", C, state),
                               atol=1e-4, rtol=1e-5)
    # C arrives in the activations' dtype and is widened first
    assert torch.equal(c_dot_state(C.bfloat16(), state),
                       c_dot_state(C.bfloat16().float(), state))


def test_forward_on_cpu_launches_no_kernel(layer):
    _, _, cfg, p = layer
    before = dict(LAUNCHES)
    mamba2_forward(cfg, p, torch.from_numpy(_x(cfg, 1, 7)))
    assert LAUNCHES == before


def test_init_params_follows_init_mamba2():
    """The port's init of the mixer leaves (stacked (nb, ...)): A_log =
    log(linspace(1, 16, h)), D = 1 and dt_bias float32, softplus(dt_bias)
    in [1e-3, 0.1]; conv biases 0 and the gated norm 1 in bf16; conv
    weights with fan-in the conv width; out_proj scaled by 1/sqrt(2L) --
    against the JAX package's init_mamba2 (mamba2.py:24-46)."""
    cfg = smoke_config(ARCH)
    jp = jax_mamba2.init_mamba2(jax_smoke_config(ARCH), jax.random.PRNGKey(0))
    mixer = init_params(cfg, 7, device="cpu")["blocks"]["sub0"]["mixer"]
    assert set(mixer) == set(jp)
    nb = cfg.num_layers
    for name, leaf in mixer.items():
        assert tuple(leaf.shape) == (nb, *jp[name].shape), name
        assert str(leaf.dtype).split(".")[-1] == str(jp[name].dtype), name
    for name in ("A_log", "D"):
        np.testing.assert_allclose(_f32(mixer[name]),
                                   np.broadcast_to(_f32(jp[name]),
                                                   mixer[name].shape),
                                   rtol=1e-6)
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert bool(((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 0.1 * (1 + 1e-5))).all())
    assert not torch.equal(mixer["dt_bias"][0], mixer["dt_bias"][1])
    for name in ("conv_x_b", "conv_bc_b"):
        assert torch.all(mixer[name] == 0)
    assert torch.all(mixer["norm"] == 1)
    out = 1 / np.sqrt(2 * cfg.num_layers)
    # (leaf, expected std before truncation); a standard normal truncated
    # at +-3 has std 0.9866, and a sample std of n entries is off by about
    # 1/sqrt(2n) relative, so the bound is 4 of those
    for leaf, std in ((mixer["in_zx"], 1 / np.sqrt(cfg.d_model)),
                      (mixer["conv_x_w"], 1 / np.sqrt(cfg.ssm_conv)),
                      (mixer["conv_bc_w"], 1 / np.sqrt(cfg.ssm_conv)),
                      (mixer["out_proj"], out / np.sqrt(cfg.d_inner))):
        tol = 4 / np.sqrt(2 * leaf.numel())
        assert abs(leaf.float().std().item() / std - 0.9866) < tol
