"""Attention at a query offset: query row i sits at position q_offset + i
of the key axis (one rank's rows of the sharded step's head_dim / seq
fallback).  The port's plain versions on rows [o, o + n) of q, at offset
o, against the JAX package's ``chunked_attention`` on the whole of q,
forward and ``jax.vjp`` (with a cotangent that is zero outside the rows);
the wrappers' checks of the offset, which run before the device is touched;
and -- on a card only -- the CUDA kernels against their plain versions at
the local shapes of the fallback's plans, with the exact zeros of dK and
dV on the key tiles that no local query reaches.

Tolerances are the JAX package's kernel tolerances (2e-5 in float32, 2e-2
in bfloat16); the bf16 gradients, whose JAX side rounds P to bf16 where the
plain backward keeps float32, are held at 2e-2 of max |ref|, the kernels'
backward criterion (chip_smoke.py).  JAX is imported by the ``jx`` fixture:
the card's machine has no JAX, and the ``gpu`` class runs there.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, dispatch
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_lse)

DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}
B, S, N, H, K, D = 2, 64, 16, 8, 2, 32
OFFSETS = [0, 24, S - N]             # first, mid and last rows
WINDOWS = [0, 16]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention
    return SimpleNamespace(jax=jax, jnp=jnp, attention=chunked_attention)


def _to_jax(jx, t):
    return jx.jnp.asarray(t.float().numpy()).astype(str(t.dtype)[6:])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _inputs(dtype, seed=0, b=B, s=S, h=H, kv=K, d=D):
    rng = np.random.default_rng(seed)
    return [_randn(rng, shape, dtype) for shape in
            ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("offset", OFFSETS)
def test_plain_forward_at_offset_matches_jax_rows(jx, offset, window, dtype):
    q, k, v, _ = _inputs(DTYPES[dtype][0])
    want = jx.attention(*(_to_jax(jx, t) for t in (q, k, v)), causal=True,
                        window=window)[:, offset:offset + N]
    rows = q[:, offset:offset + N]
    got = attention_ref(rows, k, v, causal=True, window=window,
                        q_offset=offset)
    assert got.dtype == q.dtype and got.shape == rows.shape
    tol = DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    # dispatch sends a CPU tensor to the plain version, offset and all
    assert torch.equal(dispatch.attention(rows, k, v, window=window,
                                          q_offset=offset), got)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("offset", OFFSETS)
def test_plain_backward_at_offset_matches_jax_vjp(jx, offset, window, dtype):
    """dq of the rows, dk and dv: the explicit formulas (from o and the
    log-sum-exp) and autograd through the plain forward, against jax.vjp of
    chunked_attention on the whole of q with a cotangent that is zero
    outside the rows."""
    torch_dtype, tol = DTYPES[dtype]
    q, k, v, do_full = _inputs(torch_dtype, seed=1)
    mask = torch.zeros(S, dtype=torch.bool)
    mask[offset:offset + N] = True
    do_full = torch.where(mask[None, :, None, None], do_full,
                          torch.zeros((), dtype=torch_dtype))
    kw = dict(causal=True, window=window)
    _, vjp = jx.jax.vjp(lambda a, b_, c: jx.attention(a, b_, c, **kw),
                        *(_to_jax(jx, t) for t in (q, k, v)))
    want = list(vjp(_to_jax(jx, do_full)))
    want[0] = want[0][:, offset:offset + N]
    rows, do = q[:, offset:offset + N], do_full[:, offset:offset + N]
    o = attention_ref(rows, k, v, q_offset=offset, **kw)
    lse = attention_lse_ref(rows, k, q_offset=offset, **kw)
    explicit = attention_bwd_ref(rows, k, v, o, lse, do, q_offset=offset,
                                 **kw)
    leaves = [t.clone().requires_grad_(True) for t in (rows, k, v)]
    attention_ref(*leaves, q_offset=offset, **kw).backward(do)
    for name, w, e, a in zip("qkv", want, explicit, leaves):
        w = _f32(w)
        for how, g in (("explicit", e), ("autograd", a.grad)):
            if torch_dtype == torch.float32:
                np.testing.assert_allclose(_f32(g), w, atol=tol, rtol=tol,
                                           err_msg=f"d{name} {how}")
            else:
                err = np.abs(_f32(g) - w).max()
                assert err <= tol * np.abs(w).max(), (name, how, err)
    # keys past the last row's position get no gradient
    last = offset + N
    assert not explicit[1][:, last:].any() and not explicit[2][:, last:].any()


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_lse",
                                "flash_attention_bwd"])
@pytest.mark.parametrize("offset", [-1, S - N + 1])
def test_wrappers_refuse_rows_outside_the_keys(fn, offset):
    """A negative offset, or a nonzero one whose rows run past the last
    key, raise ValueError before any allocation or launch: on CPU tensors
    too.  (At offset 0 rows past the last key stay what they were, rows
    the mask leaves with no key.)"""
    q, k, v, do = _inputs(torch.bfloat16)
    rows = q[:, :N].contiguous()
    n = dict(LAUNCHES)
    with pytest.raises(ValueError, match="lie outside"):
        if fn == "flash_attention_bwd":
            lse = torch.zeros((B, H, N), dtype=torch.float32)
            flash_attention_bwd(rows, k, v, rows, lse, rows, q_offset=offset)
        else:
            {"flash_attention": flash_attention,
             "flash_attention_lse": flash_attention_lse}[fn](
                 rows, k, v, q_offset=offset)
    assert LAUNCHES == n


# ------------------------------------------------------------- on the card --

# One rank of each fallback plan at train_4k (s = 4096, t = 16): 256 query
# rows against 4096 keys, b = 1 -- stablelm-12b (32/8 heads of 160) at
# offsets 0 and 3840, jamba (64/8 of 128), musicgen (24/24 of 64) and
# starcoder2-7b (36/4 of 128) at the last rank's 3840; starcoder2-7b's
# last rank at s = 8192 (512 rows at 7680, window 4096).
# (name, sq, sk, H, K, D, offset, window)
CARD_CASES = [("stablelm_r0", 256, 4096, 32, 8, 160, 0, 0),
              ("stablelm_r15", 256, 4096, 32, 8, 160, 3840, 0),
              ("jamba_r15", 256, 4096, 64, 8, 128, 3840, 0),
              ("musicgen_r15", 256, 4096, 24, 24, 64, 3840, 0),
              ("starcoder2_7b_r15", 256, 4096, 36, 4, 128, 3840, 0),
              ("starcoder2_7b_band", 512, 8192, 36, 4, 128, 7680, 4096)]
# every head dim each kernel was built for, in both dtypes, at a small
# shape whose offset leaves key tiles on both sides of the band
SMALL_DIMS = [32, 48, 64, 128, 160, 192]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dead_keys(sq, sk, offset, window):
    """Keys no row in [offset, offset + sq) reaches (causal, window)."""
    kp = torch.arange(sk)
    dead = kp > offset + sq - 1
    if window:
        dead |= kp <= offset - window
    return dead


def _check_on_card(cuda, b, sq, sk, H, K, D, offset, window, dtype, seed):
    rng = np.random.default_rng(seed)
    q, do = (_randn(rng, (b, sq, H, D), dtype).to(cuda) for _ in range(2))
    k, v = (_randn(rng, (b, sk, K, D), dtype).to(cuda) for _ in range(2))
    kw = dict(causal=True, window=window, q_offset=offset)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    n = LAUNCHES["flash_attention_offset"]
    o, lse = flash_attention_lse(q, k, v, **kw)
    assert LAUNCHES["flash_attention_offset"] == n + (offset > 0)
    torch.testing.assert_close(o.float(), attention_ref(q, k, v, **kw).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(lse, attention_lse_ref(q, k, **kw),
                               atol=FP32_TOL, rtol=FP32_TOL)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for a, c in zip(got, again):
        assert torch.equal(a, c)
    for g, e in zip(got, attention_bwd_ref(q, k, v, o, lse, do, **kw)):
        err = (g.float() - e.float()).abs().max().item()
        assert err <= tol * e.float().abs().max().item()
    dead = _dead_keys(sq, sk, offset, window).to(cuda)
    assert dead.any() or offset + sq == sk
    for g in got[1:]:
        assert torch.equal(g[:, dead], torch.zeros_like(g[:, dead]))


BF16_TOL, FP32_TOL = 2e-2, 2e-5


@pytest.mark.gpu
class TestFlashAttentionOffsetOnCard:
    @pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
    def test_local_shapes_match_plain(self, cuda, case):
        _, sq, sk, H, K, D, offset, window = case
        _check_on_card(cuda, 1, sq, sk, H, K, D, offset, window,
                       torch.bfloat16, seed=3)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("window", [0, 100])
    @pytest.mark.parametrize("D", SMALL_DIMS)
    def test_every_head_dim_at_an_offset(self, cuda, D, window, dtype):
        """200 rows at offset 300 of 700 keys: key tiles before the
        window's band and past the last row, ragged tiles at both ends.
        The forward at every head dim; the backward where it was built
        (not 48)."""
        if D == 48:
            rng = np.random.default_rng(5)
            q = _randn(rng, (2, 200, 8, D), DTYPES[dtype][0]).to(cuda)
            k, v = (_randn(rng, (2, 700, 2, D), DTYPES[dtype][0]).to(cuda)
                    for _ in range(2))
            kw = dict(causal=True, window=window, q_offset=300)
            tol = DTYPES[dtype][1]
            torch.testing.assert_close(
                flash_attention(q, k, v, **kw).float(),
                attention_ref(q, k, v, **kw).float(), atol=tol, rtol=tol)
            return
        _check_on_card(cuda, 2, 200, 700, 8, 2, D, 300, window,
                       DTYPES[dtype][0], seed=5)
