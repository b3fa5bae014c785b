"""The port's MLA attention (DeepSeek-V2) against the JAX package's, on the
CPU: the prefill layer, the absorbed decode layer with scalar and per-row
positions, the plain versions of the ``flash_decode_mla`` kernel against
the JAX oracles and the Pallas kernel (interpret mode), and the plain
attention at the MLA head dims 48 and 192 against ``chunked_attention``.

Inputs are drawn with numpy from a fixed seed; layer parameters come from
the JAX package's ``init_mla`` cast to float32.  The layers are compared in
float32 at 1e-4 (two frameworks summing the same products in other
orders); the kernels' plain versions at the JAX package's kernel
tolerances, 2e-5 float32 and 2e-2 bfloat16 (tests/test_flash_decode.py).
bfloat16 inputs are rounded once in torch and handed to JAX through
float32, which is exact.  The hand-written kernels are held against these
plain versions on the card (tests/test_torch_kernels.py, ``-m gpu``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.kernels.flash_decode import flash_decode_mla as pallas_mla
from repro.kernels.flash_decode import ref as jax_fd_ref
from repro.models import attention as jax_attn
from repro_torch.configs import smoke_config
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_decode import mla_decode_ref, mla_decode_splitk
from repro_torch.models.attention import (mla_attend_decode, mla_attend_train,
                                          mla_param_shapes, ring_index)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's tests, restored after: the CPU
    ops here are small, and a pool of spinning threads per test process
    only crowds the other processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "deepseek-v2-236b"
TOL = dict(atol=1e-4, rtol=1e-4)
DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}
BLOCK_S = 256            # the Pallas kernel's default cache block


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _to_jax(t):
    """A torch tensor as a JAX array of the same dtype and bits."""
    return jnp.asarray(t.float().numpy()).astype(str(t.dtype)[6:])


@pytest.fixture(scope="module")
def layer():
    """(jax cfg, jax layer params, port cfg, port layer params), float32."""
    jcfg = jax_smoke_config(ARCH)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_attn.init_mla(jcfg, jax.random.PRNGKey(3)))
    cfg = smoke_config(ARCH)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in p.items()} == mla_param_shapes(cfg)
    return jcfg, jp, cfg, p


def test_mla_attend_train_matches_jax(layer):
    jcfg, jp, cfg, p = layer
    x = np.random.default_rng(0).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32)
    pos = np.arange(10)
    jout, jcache = jax_attn.mla_attend_train(jcfg, jp, jnp.asarray(x),
                                             jnp.asarray(pos, jnp.int32))
    out, cache = mla_attend_train(cfg, p, torch.from_numpy(x),
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(_f32(out), _f32(jout), **TOL)
    assert set(cache) == set(jcache) == {"c_kv", "k_rope"}
    for name in cache:
        np.testing.assert_allclose(_f32(cache[name]), _f32(jcache[name]), **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_mla_attend_decode_matches_jax(layer, per_row):
    """A 16-slot ring of random latents; row positions 9 (scalar) or 5 and
    21 (per row: the second row's ring has wrapped)."""
    jcfg, jp, cfg, p = layer
    rng = np.random.default_rng(1)
    b, S = 2, 16
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    c_kv = rng.standard_normal((b, S, cfg.kv_lora_rank)).astype(np.float32)
    k_rope = rng.standard_normal((b, S, cfg.qk_rope_head_dim)).astype(np.float32)
    pos = np.array([5, 21]) if per_row else np.array(9)
    jout, jcache = jax_attn.mla_attend_decode(
        jcfg, jp, jnp.asarray(x), {"c_kv": jnp.asarray(c_kv),
                                   "k_rope": jnp.asarray(k_rope)},
        jnp.asarray(pos, jnp.int32))
    cache = {"c_kv": torch.from_numpy(c_kv.copy()),
             "k_rope": torch.from_numpy(k_rope.copy())}
    tpos = torch.from_numpy(pos) if per_row else int(pos)
    out, got = mla_attend_decode(cfg, p, torch.from_numpy(x), cache,
                                 ring_index(tpos, S, b, "cpu"))
    assert got["c_kv"] is cache["c_kv"]                 # written in place
    np.testing.assert_allclose(_f32(out), _f32(jout), **TOL)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_f32(got[name]), _f32(jcache[name]), **TOL)


# ---------------------------------------------------- decode plain versions --

def _mla_inputs(b, S, H, r, dr, dtype, seed=0, block_s=BLOCK_S):
    """Ring-shaped validity (row i sees a different prefix), plus a fully
    masked cache block of ``block_s`` rows in row 0 where the cache has more
    than one block."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(DTYPES[dtype][0])

    args = [randn(b, H, r), randn(b, H, dr), randn(b, S, r), randn(b, S, dr)]
    pos = rng.integers(1, 2 * S, size=b)
    age = (pos[:, None] % S - np.arange(S)[None, :]) % S
    valid = age <= np.minimum(pos[:, None], S - 1)
    if S > block_s:
        valid[0, block_s:2 * block_s] = False
        valid[0, 0] = True
    return args, valid


@pytest.mark.parametrize("block_s", [16, 48, 64, 80, 96, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S", [48, 300, 640])
def test_mla_decode_refs_match_jax(S, dtype, block_s):
    """The smoke config's widths: H=8, r=32, dr=16, denom sqrt(32+16), at
    splits the CUDA kernel takes (multiples of 16 rows; 48 for a 48-row
    cache, 64 at S=300, 96 at deepseek-v2's decode shape) and the Pallas
    kernel's 256."""
    args, valid = _mla_inputs(3, S, 8, 32, 16, dtype, block_s=block_s)
    denom = math.sqrt(48)
    jargs = [_to_jax(t) for t in args] + [jnp.asarray(valid)]
    tvalid = torch.from_numpy(valid)
    tol = DTYPES[dtype][1]

    ref = mla_decode_ref(*args, tvalid, denom=denom)
    assert ref.dtype == args[2].dtype and ref.shape == args[0].shape
    np.testing.assert_allclose(
        _f32(ref), _f32(jax_fd_ref.mla_decode_ref(*jargs, denom=denom)),
        atol=tol, rtol=tol)
    split = mla_decode_splitk(*args, tvalid, denom=denom, block_s=block_s)
    np.testing.assert_allclose(
        _f32(split), _f32(jax_fd_ref.mla_decode_splitk(
            *jargs, denom=denom, block_s=block_s)), atol=tol, rtol=tol)
    pallas = pallas_mla(*jargs, denom=denom, block_s=block_s, interpret=True)
    np.testing.assert_allclose(_f32(split), _f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(ref), _f32(split), atol=tol, rtol=tol)


def test_mla_all_invalid_row_follows_split_kv():
    """A row with no valid entry: the split-KV merge (the kernel's
    semantics, and the Pallas kernel's) gives 0, the whole-cache softmax
    the mean of c_kv."""
    args, _ = _mla_inputs(2, 300, 8, 32, 16, "float32")
    valid = np.ones((2, 300), bool)
    valid[1] = False
    denom = math.sqrt(48)
    split = mla_decode_splitk(*args, torch.from_numpy(valid), denom=denom,
                              block_s=BLOCK_S)
    assert torch.all(split[1] == 0)
    pallas = pallas_mla(*(_to_jax(t) for t in args), jnp.asarray(valid),
                        denom=denom, block_s=BLOCK_S, interpret=True)
    np.testing.assert_allclose(_f32(split), _f32(pallas), atol=2e-5, rtol=2e-5)
    ref = mla_decode_ref(*args, torch.from_numpy(valid), denom=denom)
    mean_c = args[2][1].mean(dim=0).expand(8, -1)
    np.testing.assert_allclose(_f32(ref[1]), _f32(mean_c), atol=2e-5)


def test_dispatch_sends_cpu_tensors_to_the_plain_version():
    from repro_torch.kernels import LAUNCHES
    before = dict(LAUNCHES)
    args, valid = _mla_inputs(2, 300, 8, 32, 16, "bfloat16")
    valid = torch.from_numpy(valid)
    assert torch.equal(dispatch.mla_flash_decode(*args, valid, denom=7.0),
                       mla_decode_ref(*args, valid, denom=7.0))
    assert LAUNCHES == before


# --------------------------------------------- attention at the MLA widths --

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", [48, 192])
def test_attention_ref_at_mla_head_dims_matches_chunked(D, dtype):
    """MHA (H = K, as the MLA prefill), causal, scale 1/sqrt(D); 96 tokens
    in chunks of 32 so the JAX side merges several chunks."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 96, 4, D)).astype(
        np.float32)).to(DTYPES[dtype][0]) for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    want = jax_attn.chunked_attention(*(_to_jax(t) for t in (q, k, v)),
                                      causal=True, softmax_scale=scale,
                                      q_chunk=32, kv_chunk=32)
    got = attention_ref(q, k, v, causal=True, softmax_scale=scale)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
