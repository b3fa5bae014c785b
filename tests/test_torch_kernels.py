"""The port's kernels' plain versions against the JAX package's oracles and
Pallas kernels (interpret mode), dispatch by device, and -- on a card only
-- the hand-written CUDA kernels against their plain versions.  (The
training path's plain versions -- Adam, the attention gradient and
log-sum-exp -- are held against JAX in tests/test_torch_train.py.)

Inputs are drawn with numpy from a fixed seed; bfloat16 inputs are rounded
once in torch and handed to JAX through float32, which is exact, so both
sides see the same bits.  Tolerances are the JAX package's own kernel
tolerances: 2e-5 in float32, 2e-2 in bfloat16 (tests/test_kernels.py,
tests/test_flash_decode.py).

JAX is imported by the ``jx`` fixture, not at module level: the card's
machine has no JAX, and the ``gpu`` class runs there.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, dispatch
from repro_torch.kernels.adam_update import adam_ref, adam_update
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_lse)
from repro_torch.kernels.flash_decode.flash_decode import block_s
from repro_torch.kernels.flash_decode import (flash_decode_gqa,
                                              flash_decode_mla, gqa_decode_ref,
                                              gqa_decode_splitk, mla_block_s,
                                              mla_decode_ref,
                                              mla_decode_splitk)
from repro_torch.kernels.flash_decode.flash_decode_mla import (_launch,
                                                             launch_plan)
from repro_torch.kernels.ssd_scan import ssd_scan

DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}

# the shapes of tests/test_kernels.py::test_flash_attention_sweep, then
# lengths, windows and GQA groups across the bf16 kernels' 64-row q tiles
# and 64-key k tiles
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 8, 32, True, 64),        # MHA + sliding window
    (2, 64, 192, 4, 1, 64, False, 0),         # MQA, cross-length
    (1, 96, 96, 6, 3, 128, True, 0),          # non-pow2 seq, G = 3
    (1, 128, 128, 4, 4, 64, True, 32),
    (1, 1, 1, 4, 2, 64, True, 0),             # one query, one key
    (1, 63, 63, 8, 8, 32, True, 0),           # one partial tile
    (2, 65, 65, 6, 2, 64, True, 32),          # a row past a tile, window 32
    (1, 129, 129, 16, 16, 128, True, 0),      # H = K = 16, G = 1
    (1, 200, 200, 8, 1, 64, True, 64),        # G = 8, window 64
    (2, 100, 260, 4, 2, 128, False, 0),       # sq != sk, ragged k tile
]
# a single key gives dq = dk = 0 in exact arithmetic, so a tolerance
# relative to max |ref| would hold the kernel to the plain version's
# float32 rounding noise (~1e-7) there
BWD_CASES = [c for c in ATTN_CASES if c[2] > 1]

# the head dims this slice's kernels were built for: the forward and the
# GQA decode at stablelm-12b's 160 (5120 / 32), the backward at
# deepseek-v2's MLA qk width 192 (dn + dr), with GQA groups, windows,
# sq != sk and ragged tiles (b, sq, sk, H, K, D, causal, window)
WIDE_ATTN_CASES = [
    (1, 40, 40, 4, 2, 160, True, 0),
    (1, 70, 70, 4, 1, 160, True, 16),         # G = 4, window
    (2, 24, 56, 2, 2, 160, False, 0),         # sq != sk
    (1, 40, 40, 4, 4, 192, True, 0),
    (1, 70, 70, 2, 2, 192, True, 16),
]
# the backward at stablelm-12b's 160: 4 query heads a KV head as at full
# width, causal, across the 64-key k tiles and the dQ block's 32-key tiles
# (b, sq, sk, H, K, D, causal, window)
BWD_160_CASES = [
    (1, 100, 100, 8, 2, 160, True, 0),
    (2, 130, 130, 4, 1, 160, True, 0),        # MQA, a row past two k tiles
    (1, 70, 70, 4, 1, 160, True, 16),         # G = 4, window
    (2, 24, 56, 2, 2, 160, False, 0),         # sq != sk
]
# stablelm-12b's GQA at its smoke-sized cache: 8 query heads on 2 KV heads
# of 160, G = 4 as at full width
WIDE_DECODE = dict(H=8, K=2, D=160)

BLOCK_S = 256            # the Pallas kernels' default cache block


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and oracles."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import attention_ref as jax_ref
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.flash_decode import flash_decode_gqa
    from repro.kernels.flash_decode import ref as fd_ref
    return SimpleNamespace(jnp=jnp, attention_ref=jax_ref,
                           flash_attention=flash_attention,
                           flash_decode_gqa=flash_decode_gqa, fd_ref=fd_ref)


def _to_jax(jx, t):
    """A torch tensor as a JAX array of the same dtype and bits."""
    return jx.jnp.asarray(t.float().numpy()).astype(str(t.dtype)[6:])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(DTYPES[dtype][0])


def _attn_inputs(case, dtype, seed=0):
    b, sq, sk, H, K, D, _, _ = case
    rng = np.random.default_rng(seed)
    return [_randn(rng, s, dtype) for s in
            ((b, sq, H, D), (b, sk, K, D), (b, sk, K, D))]


def _decode_inputs(b, S, H, K, D, dtype, seed=0):
    """Ring-shaped validity (row i sees a different prefix), plus a fully
    masked cache block in row 0 where the cache has more than one block."""
    rng = np.random.default_rng(seed)
    qkv = [_randn(rng, s, dtype) for s in
           ((b, 1, H, D), (b, S, K, D), (b, S, K, D))]
    pos = rng.integers(1, 2 * S, size=b)
    age = (pos[:, None] % S - np.arange(S)[None, :]) % S
    valid = age <= np.minimum(pos[:, None], S - 1)
    if S > BLOCK_S:
        valid[0, BLOCK_S:2 * BLOCK_S] = False
        valid[0, 0] = True               # the row itself keeps a valid entry
    return qkv, valid


# --------------------------------------------------------------- attention --

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_ref_matches_jax_ref(jx, case, dtype):
    causal, window = case[6], case[7]
    q, k, v = _attn_inputs(case, dtype)
    want = jx.attention_ref(*(_to_jax(jx, t) for t in (q, k, v)),
                            causal=causal, window=window)
    got = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [ATTN_CASES[1], ATTN_CASES[3]])
def test_attention_ref_matches_pallas_kernel(jx, case, dtype):
    causal, window = case[6], case[7]
    q, k, v = _attn_inputs(case, dtype, seed=1)
    want = jx.flash_attention(*(_to_jax(jx, t) for t in (q, k, v)),
                              causal=causal, window=window, block_q=64,
                              block_k=64, interpret=True)
    got = attention_ref(q, k, v, causal=causal, window=window)
    tol = DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", WIDE_ATTN_CASES)
def test_attention_ref_at_wide_head_dims_matches_jax(jx, case, dtype):
    """The plain forward at head dims 160 and 192 against JAX's
    attention_ref, as at the narrower widths."""
    test_attention_ref_matches_jax_ref(jx, case, dtype)


@pytest.mark.parametrize("case", WIDE_ATTN_CASES + BWD_160_CASES[:2])
def test_attention_bwd_ref_at_wide_head_dims_matches_jax_vjp(jx, case):
    """The plain backward (explicit formulas from o and lse) and autograd
    through the plain forward at head dims 160 and 192, float32, against
    jax.vjp of JAX's attention_ref: 2e-5 (sum order)."""
    import jax
    causal, window = case[6], case[7]
    kw = dict(causal=causal, window=window)
    q, k, v = _attn_inputs(case, "float32", seed=4)
    do = _randn(np.random.default_rng(5), q.shape, "float32")
    _, vjp = jax.vjp(lambda a, b_, c: jx.attention_ref(a, b_, c, **kw),
                     *(_to_jax(jx, t) for t in (q, k, v)))
    want = vjp(_to_jax(jx, do))
    o = attention_ref(q, k, v, **kw)
    explicit = attention_bwd_ref(q, k, v, o, attention_lse_ref(q, k, **kw),
                                 do, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attention_ref(*leaves, **kw).backward(do)
    for name, w, e, a in zip("qkv", want, explicit, leaves):
        np.testing.assert_allclose(_f32(e), _f32(w), atol=2e-5, rtol=2e-5,
                                   err_msg=f"d{name} explicit")
        np.testing.assert_allclose(_f32(a.grad), _f32(w), atol=2e-5,
                                   rtol=2e-5, err_msg=f"d{name} autograd")


# ------------------------------------------------------------------ decode --

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S", [48, 300, 640])
def test_decode_refs_match_jax(jx, S, dtype):
    (q, k, v), valid = _decode_inputs(3, S, 8, 2, 32, dtype)
    jargs = [_to_jax(jx, t) for t in (q, k, v)] + [jx.jnp.asarray(valid)]
    tvalid = torch.from_numpy(valid)
    tol = DTYPES[dtype][1]

    ref = gqa_decode_ref(q, k, v, tvalid)
    np.testing.assert_allclose(_f32(ref), _f32(jx.fd_ref.gqa_decode_ref(*jargs)),
                               atol=tol, rtol=tol)
    split = gqa_decode_splitk(q, k, v, tvalid, block_s=BLOCK_S)
    np.testing.assert_allclose(
        _f32(split), _f32(jx.fd_ref.gqa_decode_splitk(*jargs, block_s=BLOCK_S)),
        atol=tol, rtol=tol)
    pallas = jx.flash_decode_gqa(*jargs, block_s=BLOCK_S, interpret=True)
    np.testing.assert_allclose(_f32(split), _f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(ref), _f32(split), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S", [48, 300])
def test_decode_refs_at_head_dim_160_match_jax(jx, S, dtype):
    """The plain GQA decode and its split-KV form at stablelm-12b's head
    dim 160 (G = 4) against JAX's gqa_decode_ref and the Pallas kernel in
    interpret mode."""
    w = WIDE_DECODE
    (q, k, v), valid = _decode_inputs(3, S, w["H"], w["K"], w["D"], dtype,
                                      seed=11)
    jargs = [_to_jax(jx, t) for t in (q, k, v)] + [jx.jnp.asarray(valid)]
    tvalid = torch.from_numpy(valid)
    tol = DTYPES[dtype][1]
    ref = gqa_decode_ref(q, k, v, tvalid)
    np.testing.assert_allclose(_f32(ref), _f32(jx.fd_ref.gqa_decode_ref(*jargs)),
                               atol=tol, rtol=tol)
    split = gqa_decode_splitk(q, k, v, tvalid, block_s=BLOCK_S)
    pallas = jx.flash_decode_gqa(*jargs, block_s=BLOCK_S, interpret=True)
    np.testing.assert_allclose(_f32(split), _f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(ref), _f32(split), atol=tol, rtol=tol)


def test_all_invalid_row_follows_split_kv(jx):
    """A row with no valid entry: the split-KV merge gives 0 (the kernel's
    semantics), the whole-cache softmax the mean of V."""
    (q, k, v), _ = _decode_inputs(2, 300, 4, 2, 32, "float32")
    valid = np.ones((2, 300), bool)
    valid[1] = False
    split = gqa_decode_splitk(q, k, v, torch.from_numpy(valid),
                              block_s=BLOCK_S)
    assert torch.all(split[1] == 0)
    pallas = jx.flash_decode_gqa(*(_to_jax(jx, t) for t in (q, k, v)),
                                 jx.jnp.asarray(valid), block_s=BLOCK_S,
                                 interpret=True)
    np.testing.assert_allclose(_f32(split), _f32(pallas), atol=2e-5,
                               rtol=2e-5)
    ref = gqa_decode_ref(q, k, v, torch.from_numpy(valid))
    mean_v = v[1].mean(dim=0).repeat_interleave(2, dim=0)      # (H, D)
    np.testing.assert_allclose(_f32(ref[1, 0]), _f32(mean_v), atol=2e-5)


# ---------------------------------------------------------------- dispatch --

def test_dispatch_on_cpu_runs_the_plain_versions():
    before = dict(LAUNCHES)
    q, k, v = _attn_inputs(ATTN_CASES[1], "bfloat16")
    assert torch.equal(dispatch.attention(q, k, v, window=64),
                       attention_ref(q, k, v, window=64))
    (dq, dk, dv), valid = _decode_inputs(2, 300, 8, 2, 32, "float32")
    valid = torch.from_numpy(valid)
    assert torch.equal(dispatch.flash_decode(dq, dk, dv, valid),
                       gqa_decode_ref(dq, dk, dv, valid))
    with dispatch.force("ref"):
        assert torch.equal(dispatch.flash_decode(dq, dk, dv, valid),
                           gqa_decode_ref(dq, dk, dv, valid))
    assert LAUNCHES == before


def test_dispatch_on_cpu_differentiates_the_plain_version():
    """With grad on, a CPU tensor still takes attention_ref, whose gradient
    is PyTorch's autograd; it agrees with the explicit backward formulas."""
    before = dict(LAUNCHES)
    q, k, v = (t.requires_grad_(True) for t in
               _attn_inputs(ATTN_CASES[1], "float32"))
    do = _randn(np.random.default_rng(5), q.shape, "float32")
    o = dispatch.attention(q, k, v, window=64)
    assert torch.equal(o, attention_ref(q, k, v, window=64))
    o.backward(do)
    with torch.no_grad():
        want = attention_bwd_ref(q, k, v, o, attention_lse_ref(q, k, window=64),
                                 do, window=64)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, w, atol=2e-5, rtol=2e-5)
    assert LAUNCHES == before


def test_kernels_refuse_what_they_do_not_take():
    q, k, v = _attn_inputs(ATTN_CASES[0], "float32")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)
    (dq, dk, dv), _ = _decode_inputs(2, 48, 8, 2, 32, "float32")
    valid = torch.ones((2, 48), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_gqa(dq, dk, dv, valid)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, q, torch.zeros(q.shape[0], q.shape[2],
                                                    q.shape[1]), q)
    g = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        adam_update(g, g, g, g, g, lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8,
                    wd=0.0, c1=0.1, c2=0.05)
    with pytest.raises(ValueError):
        with dispatch.force("kernel"):
            pass
    # a meta tensor goes to the kernel's wrapper (the dry run's stand-in),
    # which refuses there what the kernel does not take
    mq, mk, mv = q.to("meta"), k.to("meta"), v.to("meta")
    assert dispatch.attention(mq, mk, mv).device.type == "meta"
    with pytest.raises(ValueError, match="head dim"):
        dispatch.attention(mq[..., :40], mk[..., :40], mv[..., :40])
    # and a device with neither a kernel nor a plain version raises
    other = SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(ValueError, match="device"):
        dispatch._use_kernel(other)


def _no_backward_calls():
    """A call of each wrapper whose kernel has no backward, at shapes it
    takes, on the CPU: (name, fn(tensors), tensors)."""
    (q, k, v), valid = _decode_inputs(2, 48, 8, 2, 32, "float32")
    valid = torch.from_numpy(valid)
    mla = [torch.zeros(s) for s in ((2, 8, 32), (2, 8, 16), (2, 48, 32),
                                    (2, 48, 16))]
    rng = np.random.default_rng(6)
    ssd = [_randn(rng, s, "float32") for s in
           ((1, 8, 2, 32), (1, 8, 2), (2,), (1, 8, 16), (1, 8, 16), (2,), (2,))]
    return {"ssd_scan": (lambda *t: ssd_scan(*t), ssd),
            "flash_decode_gqa": (lambda *t: flash_decode_gqa(*t, valid),
                                 [q, k, v]),
            "flash_decode_mla": (lambda *t: flash_decode_mla(*t, valid,
                                                             denom=1.0), mla)}


@pytest.mark.parametrize("name", ["ssd_scan", "flash_decode_gqa",
                                  "flash_decode_mla"])
def test_kernels_without_a_backward_refuse_inputs_that_require_grad(name):
    """The SSD scan and both decodes have no backward kernel: with grad on
    and an input that requires grad they raise NotImplementedError, before
    the device check (so on the CPU too), naming what is missing; under
    no_grad, or with no input requiring grad, the same call reaches the
    device check."""
    fn, tensors = _no_backward_calls()[name]
    for i in range(len(tensors)):
        args = [t.clone().requires_grad_(j == i) for j, t in enumerate(tensors)]
        with pytest.raises(NotImplementedError,
                           match=f"{name} has no backward: .*requires? grad"):
            fn(*args)
        with torch.no_grad():
            with pytest.raises(ValueError, match="CUDA"):
                fn(*args)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*tensors)
    if name == "ssd_scan":
        with pytest.raises(NotImplementedError, match="the SSD backward"):
            fn(*[t.clone().requires_grad_(True) for t in tensors])


def test_wrappers_reject_head_dims_they_were_not_built_for():
    """Each wrapper checks its own tuple of head dims before it looks at
    the device, so this holds on the CPU: the forward takes the MLA widths
    48 and 192 and stablelm's 160 (and then refuses the CPU tensor) but not
    96, the backward takes 160 and 192 but not 48, the GQA decode takes 160
    but not 192, and the MLA decode takes r in (32, 512), dr in (16, 64)."""
    q = torch.zeros((1, 8, 2, 192))
    q160 = torch.zeros((1, 8, 2, 160))
    q48 = torch.zeros((1, 8, 2, 48))
    for t in (q, q160):
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention(t, t, t)
    with pytest.raises(ValueError, match="head dim 96"):
        flash_attention(*(torch.zeros((1, 8, 2, 96)),) * 3)
    for t in (q, q160):
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_bwd(t, t, t, t, torch.zeros((1, 2, 8)), t)
    with pytest.raises(ValueError, match="flash_attention_bwd: head dim 48"):
        flash_attention_bwd(q48, q48, q48, q48, torch.zeros((1, 2, 8)), q48)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_gqa(q160[:, :1], q160, q160,
                         torch.ones((1, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="flash_decode_gqa: head dim 192"):
        flash_decode_gqa(q[:, :1], q, q, torch.ones((1, 8), dtype=torch.bool))
    valid = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_mla(torch.zeros(1, 2, 512), torch.zeros(1, 2, 64),
                         torch.zeros(1, 8, 512), torch.zeros(1, 8, 64), valid,
                         denom=1.0)
    with pytest.raises(ValueError, match="latent dim 64"):
        flash_decode_mla(torch.zeros(1, 2, 64), torch.zeros(1, 2, 16),
                         torch.zeros(1, 8, 64), torch.zeros(1, 8, 16), valid,
                         denom=1.0)


def test_wrappers_reject_unaligned_tensors():
    """The kernels copy rows with 16-byte cp.async: a contiguous view at a
    storage offset off that grid is refused, for q, k, v and the backward's
    o and do, before the wrapper looks at the device."""
    good = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16)
    bad = torch.zeros(1 + good.numel(), dtype=torch.bfloat16)[1:].view(good.shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 2
    for i, arg in enumerate("qkv"):
        args = [good, good, good]
        args[i] = bad
        for fn in (flash_attention, flash_attention_lse):
            with pytest.raises(ValueError, match=f"16-byte aligned tensors, got {arg}"):
                fn(*args)
        with pytest.raises(ValueError, match=f"16-byte aligned tensors, got {arg}"):
            flash_attention_bwd(*args, good, torch.zeros((2, 2, 8)), good)
    lse = torch.zeros((2, 2, 8))
    with pytest.raises(ValueError, match="16-byte aligned tensors, got o"):
        flash_attention_bwd(good, good, good, bad, lse, good)
    with pytest.raises(ValueError, match="16-byte aligned tensors, got do"):
        flash_attention_bwd(good, good, good, good, lse, bad)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(good, good, good, good, lse, good)


# ------------------------------------------------------------- on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
class TestKernelsOnCard:
    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("case", ATTN_CASES)
    def test_flash_attention_matches_plain(self, cuda, case, dtype):
        causal, window = case[6], case[7]
        q, k, v = (t.to(cuda) for t in _attn_inputs(case, dtype))
        n = LAUNCHES["flash_attention"]
        got = flash_attention(q, k, v, causal=causal, window=window)
        assert LAUNCHES["flash_attention"] == n + 1
        want = attention_ref(q, k, v, causal=causal, window=window)
        tol = DTYPES[dtype][1]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        with dispatch.force("ref"):
            assert torch.equal(dispatch.attention(q, k, v, causal=causal,
                                                  window=window), want)
        assert torch.equal(dispatch.attention(q, k, v, causal=causal,
                                              window=window), got)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("S", [48, 300, 544, 640])
    def test_flash_decode_matches_plain(self, cuda, S, dtype):
        (q, k, v), valid = _decode_inputs(3, S, 24, 8, 128, dtype)
        q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
        valid = torch.from_numpy(valid).to(cuda)
        valid[2] = False                       # one all-invalid row
        n = LAUNCHES["flash_decode_gqa"]
        got = flash_decode_gqa(q, k, v, valid)
        assert LAUNCHES["flash_decode_gqa"] == n + 1
        want = gqa_decode_splitk(q, k, v, valid, block_s=block_s(k))
        tol = DTYPES[dtype][1]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        assert torch.all(got[2] == 0)
        ref = gqa_decode_ref(q[:2], k[:2], v[:2], valid[:2])
        torch.testing.assert_close(got[:2].float(), ref.float(), atol=tol,
                                   rtol=tol)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("S", [300, 544])
    def test_flash_decode_at_jamba_group_size(self, cuda, S, dtype):
        """jamba's attention: 64 query heads on 8 KV heads (G = 8 heads a
        block where llama has 3), against the split-KV oracle at the
        kernel's split and the plain version; an all-invalid row gives 0."""
        (q, k, v), valid = _decode_inputs(8, S, 64, 8, 128, dtype, seed=7)
        q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
        valid = torch.from_numpy(valid).to(cuda)
        valid[5] = False
        got = flash_decode_gqa(q, k, v, valid)
        tol = DTYPES[dtype][1]
        torch.testing.assert_close(
            got.float(), gqa_decode_splitk(q, k, v, valid,
                                           block_s=block_s(k)).float(),
            atol=tol, rtol=tol)
        assert torch.all(got[5] == 0)
        live = valid.any(dim=1)
        torch.testing.assert_close(
            got[live].float(), gqa_decode_ref(q[live], k[live], v[live],
                                              valid[live]).float(),
            atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("edge", ["below_one_split", "one_row_past",
                                      "all_valid"])
    def test_flash_decode_at_split_edges(self, cuda, edge, dtype):
        """A cache shorter than one of the kernel's splits, one row past a
        split, and every row valid, against the split-KV oracle at the
        kernel's own split size; the split is 64 rows at these shapes."""
        bs = block_s(torch.empty((3, 544, 8, 1), device=cuda))
        S = {"below_one_split": bs - 5, "one_row_past": bs + 1,
             "all_valid": 544}[edge]
        (q, k, v), valid = _decode_inputs(3, S, 24, 8, 128, dtype, seed=3)
        q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
        valid = torch.from_numpy(valid).to(cuda)
        if edge != "below_one_split":
            valid[:, S - 1] = True           # the split's one row counts
        if edge == "all_valid":
            valid[:] = True
        assert block_s(k) == bs == 64
        got = flash_decode_gqa(q, k, v, valid)
        tol = DTYPES[dtype][1]
        torch.testing.assert_close(
            got.float(), gqa_decode_splitk(q, k, v, valid, block_s=bs).float(),
            atol=tol, rtol=tol)
        torch.testing.assert_close(
            got.float(), gqa_decode_ref(q, k, v, valid).float(), atol=tol,
            rtol=tol)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("shape", [(8, 2048, 24, 8, 128),
                                       (1, 2048, 64, 8, 128),
                                       (3, 300, 8, 2, 32)])
    def test_flash_decode_returns_lse(self, cuda, shape, dtype):
        """``return_lse``: the float32 output and the log-sum-exp against
        the plain version (out 2e-2 / 2e-5, lse 2e-2 / 1e-5 absolute; one
        rank's shapes of a sharded decode at 2,048 slots, llama3.2-3b's
        and jamba's), an all-invalid row giving 0 and -inf exactly, one
        launch; without the flag, v's dtype, the flagged output rounded
        once, and the same bits call after call."""
        (q, k, v), valid = _decode_inputs(*shape, dtype, seed=5)
        q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
        valid = torch.from_numpy(valid).to(cuda)
        bad = shape[0] - 1
        valid[bad] = False
        n = LAUNCHES["flash_decode_gqa"]
        o, lse = flash_decode_gqa(q, k, v, valid, return_lse=True)
        assert LAUNCHES["flash_decode_gqa"] == n + 1
        assert o.dtype == lse.dtype == torch.float32
        assert lse.shape == (shape[0], shape[2])
        want_o, want_lse = gqa_decode_ref(q, k, v, valid, return_lse=True)
        tol = DTYPES[dtype][1]
        lse_tol = 1e-5 if dtype == "float32" else 2e-2
        live = valid.any(dim=1)
        torch.testing.assert_close(o[live], want_o[live], atol=tol, rtol=tol)
        torch.testing.assert_close(lse[live], want_lse[live], atol=lse_tol,
                                   rtol=0)
        assert torch.all(o[bad] == 0)
        assert torch.all(lse[bad] == float("-inf"))
        plain = flash_decode_gqa(q, k, v, valid)
        assert plain.dtype == DTYPES[dtype][0]
        assert torch.equal(plain, o.to(plain.dtype))
        assert torch.equal(flash_decode_gqa(q, k, v, valid), plain)

    def test_flash_decode_never_reads_masked_slots(self, cuda):
        """Non-finite K and V in masked slots leave the output unchanged:
        the kernel reads neither for a masked row."""
        (q, k, v), valid = _decode_inputs(3, 640, 24, 8, 128, "bfloat16")
        q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
        valid = torch.from_numpy(valid).to(cuda)
        clean = flash_decode_gqa(q, k, v, valid)
        k_bad, v_bad = k.clone(), v.clone()
        k_bad[~valid] = float("nan")
        v_bad[~valid] = float("inf")
        assert torch.equal(flash_decode_gqa(q, k_bad, v_bad, valid), clean)

    def test_kernels_raise_on_unsupported_head_dim(self, cuda):
        q = torch.zeros((1, 8, 2, 96), device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(q, q, q)
        q = torch.zeros((1, 8, 2, 48), device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention_bwd(q, q, q, q, torch.zeros((1, 2, 8), device=cuda),
                                q)
        for D in (48, 192):
            q = torch.zeros((1, 8, 2, D), device=cuda)
            with pytest.raises(ValueError, match="head dim"):
                flash_decode_gqa(q[:, :1], q, q, torch.ones(
                    (1, 8), dtype=torch.bool, device=cuda))

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("case", [c for c in WIDE_ATTN_CASES
                                      if c[5] == 160])
    def test_flash_attention_at_head_dim_160(self, cuda, case, dtype):
        """stablelm-12b's width: GQA, a window, sq != sk, against the plain
        version, and the lse at 2e-5."""
        causal, window = case[6], case[7]
        kw = dict(causal=causal, window=window)
        q, k, v = (t.to(cuda) for t in _attn_inputs(case, dtype))
        got, lse = flash_attention_lse(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        tol = DTYPES[dtype][1]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, attention_lse_ref(q, k, **kw),
                                   atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("S", [300, 544])
    def test_flash_decode_at_head_dim_160(self, cuda, S, dtype):
        """stablelm-12b's decode: 32 query heads on 8 KV heads of 160 (G =
        4), two whole splits masked, an all-invalid row, against the
        split-KV oracle at the kernel's split and the plain version."""
        (q, k, v), valid = _decode_inputs(4, S, 32, 8, 160, dtype, seed=12)
        q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
        valid = torch.from_numpy(valid).to(cuda)
        bs = block_s(k)
        valid[0, bs:3 * bs] = False
        valid[0, 0] = True
        valid[3] = False
        n = LAUNCHES["flash_decode_gqa"]
        got = flash_decode_gqa(q, k, v, valid)
        assert LAUNCHES["flash_decode_gqa"] == n + 1
        tol = DTYPES[dtype][1]
        torch.testing.assert_close(
            got.float(), gqa_decode_splitk(q, k, v, valid,
                                           block_s=bs).float(),
            atol=tol, rtol=tol)
        assert torch.all(got[3] == 0)
        torch.testing.assert_close(
            got[:3].float(), gqa_decode_ref(q[:3], k[:3], v[:3],
                                            valid[:3]).float(),
            atol=tol, rtol=tol)
        k_bad, v_bad = k.clone(), v.clone()
        k_bad[~valid] = float("nan")
        v_bad[~valid] = float("inf")
        assert torch.equal(flash_decode_gqa(q, k_bad, v_bad, valid), got)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("D", [48, 192])
    @pytest.mark.parametrize("s", [100, 200])
    def test_flash_attention_at_mla_head_dims(self, cuda, s, D, dtype):
        """The MLA prefill's widths: MHA, causal, scale 1/sqrt(D), a ragged
        q tile (s = 100; s = 200 also crosses D = 192's 128-row q tile),
        and the lse at 2e-5."""
        q, k, v = (t.to(cuda) for t in _attn_inputs(
            (2, s, s, 8, 8, D, True, 0), dtype))
        got, lse = flash_attention_lse(q, k, v, softmax_scale=D ** -0.5)
        want = attention_ref(q, k, v, softmax_scale=D ** -0.5)
        err = (got.float() - want.float()).abs().max()
        assert err <= DTYPES[dtype][1] * want.float().abs().max(), err
        torch.testing.assert_close(
            lse, attention_lse_ref(q, k, softmax_scale=D ** -0.5), atol=2e-5,
            rtol=2e-5)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("dims", [(8, 32, 16), (128, 512, 64),
                                      (20, 512, 16)])
    @pytest.mark.parametrize("S", [48, 300, 544, 640])
    def test_flash_decode_mla_matches_plain(self, cuda, S, dims, dtype):
        """Ring validity per row, a masked run of 256 rows (S > 512) and an
        all-invalid row, against the split-KV oracle at the kernel's own
        split (S = 300 is not a multiple of it); max|d| <= tol * max|ref|."""
        H, r, dr = dims
        rng = np.random.default_rng(8)
        args = [_randn(rng, s, dtype).to(cuda) for s in
                ((3, H, r), (3, H, dr), (3, S, r), (3, S, dr))]
        _, valid = _decode_inputs(3, S, 1, 1, 32, "float32", seed=9)
        valid = torch.from_numpy(valid).to(cuda)
        valid[2] = False
        denom = (128 + dr) ** 0.5
        n = LAUNCHES["flash_decode_mla"]
        got = flash_decode_mla(*args, valid, denom=denom)
        assert LAUNCHES["flash_decode_mla"] == n + 1
        assert got.dtype == args[2].dtype and got.shape == args[0].shape
        tol = DTYPES[dtype][1]
        want = mla_decode_splitk(*args, valid, denom=denom,
                                 block_s=mla_block_s(args[0], args[2]))
        assert (got.float() - want.float()).abs().max() <= \
            tol * want.float().abs().max()
        assert torch.all(got[2] == 0)
        ref = mla_decode_ref(*(a[:2] for a in args), valid[:2], denom=denom)
        assert (got[:2].float() - ref.float()).abs().max() <= \
            tol * ref.float().abs().max()
        with dispatch.force("ref"):
            assert torch.equal(dispatch.mla_flash_decode(
                *args, valid, denom=denom), mla_decode_ref(
                    *args, valid, denom=denom))
        assert torch.equal(dispatch.mla_flash_decode(*args, valid,
                                                     denom=denom), got)

    def test_flash_decode_mla_split_at_decode_shape(self, cuda):
        """deepseek-v2's decode: 96-row splits, grid (6 splits, 2 head
        tiles, 8) = 96 blocks, one wave on an H100, each (head tile,
        batch)'s splits merged in one cluster.  The split depends on the
        cache length alone: the same at b=1 and in float32 (16 heads a
        block, a merge kernel); a 9,000-row cache takes 9 splits of 1024
        rows, merged by a second kernel."""
        def plan(b, S, dtype=torch.bfloat16):
            return launch_plan(
                torch.empty((b, 128, 512), dtype=dtype, device=cuda),
                torch.empty((b, S, 512), dtype=dtype, device=cuda))
        assert plan(8, 544) == (96, (6, 2, 8), True)
        assert mla_block_s(torch.empty((8, 128, 512), device=cuda),
                           torch.empty((8, 544, 512), device=cuda)) == 96
        assert plan(1, 544) == (96, (6, 2, 1), True)
        assert plan(8, 544, torch.float32) == (96, (6, 8, 8), False)
        assert plan(2, 9000) == (1024, (9, 2, 2), False)
        assert plan(1, 48) == (48, (1, 2, 1), True)

    @pytest.mark.parametrize("S", [544, 9000])
    def test_flash_decode_mla_batch_invariant(self, cuda, S):
        """Each batch row alone gives the same bits as in a batch of 8:
        the split does not depend on the batch (a cluster merge at S=544,
        a merge kernel at S=9000)."""
        rng = np.random.default_rng(16)
        args = [_randn(rng, s, "bfloat16").to(cuda) for s in
                ((8, 128, 512), (8, 128, 64), (8, S, 512), (8, S, 64))]
        _, valid = _decode_inputs(8, S, 1, 1, 32, "float32", seed=17)
        args.append(torch.from_numpy(valid).to(cuda))
        got = flash_decode_mla(*args, denom=14.0)
        alone = torch.cat([flash_decode_mla(*(t[i:i + 1] for t in args),
                                            denom=14.0) for i in range(8)])
        assert torch.equal(alone, got)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("S", [48, 300, 544, 640])
    def test_flash_decode_mla_two_splits_masked(self, cuda, S, dtype):
        """deepseek-v2's widths at b=8: the second and third of the kernel's
        splits masked in every row (S = 300 and 544 end in a short split),
        against the split-KV oracle at that split and the whole cache."""
        rng = np.random.default_rng(12)
        args = [_randn(rng, s, dtype).to(cuda) for s in
                ((8, 128, 512), (8, 128, 64), (8, S, 512), (8, S, 64))]
        _, valid = _decode_inputs(8, S, 1, 1, 32, "float32", seed=13)
        valid = torch.from_numpy(valid).to(cuda)
        bs = mla_block_s(args[0], args[2])
        valid[:, bs:3 * bs] = False
        valid[:, 0] = True
        got = flash_decode_mla(*args, valid, denom=14.0)
        tol = DTYPES[dtype][1]
        for want in (mla_decode_splitk(*args, valid, denom=14.0, block_s=bs),
                     mla_decode_ref(*args, valid, denom=14.0)):
            assert (got.float() - want.float()).abs().max() <= \
                tol * want.float().abs().max()

    @pytest.mark.parametrize("split", [16, 80, 544])
    def test_flash_decode_mla_at_a_given_split(self, cuda, split):
        """A launch at another split (as chip_smoke.py --mla-splits makes
        them): 34 splits merge by a second kernel, 7 and 1 in clusters; a
        split off the 16-row grid is refused."""
        rng = np.random.default_rng(14)
        args = [_randn(rng, s, "bfloat16").to(cuda) for s in
                ((8, 128, 512), (8, 128, 64), (8, 544, 512), (8, 544, 64))]
        _, valid = _decode_inputs(8, 544, 1, 1, 32, "float32", seed=15)
        valid = torch.from_numpy(valid).to(cuda)
        got = _launch(*args, valid, 14.0, split)
        want = mla_decode_splitk(*args, valid, denom=14.0, block_s=split)
        assert (got.float() - want.float()).abs().max() <= \
            2e-2 * want.float().abs().max()
        with pytest.raises(RuntimeError, match="launch failed"):
            _launch(*args, valid, 14.0, 40)

    def test_flash_decode_mla_refuses_unaligned(self, cuda):
        buf = torch.zeros(1 + 8 * 512, dtype=torch.bfloat16, device=cuda)
        c_kv = buf[1:].view(1, 8, 512)
        with pytest.raises(ValueError, match="aligned"):
            flash_decode_mla(torch.zeros(1, 2, 512, dtype=torch.bfloat16,
                                         device=cuda),
                             torch.zeros(1, 2, 64, dtype=torch.bfloat16,
                                         device=cuda),
                             c_kv, torch.zeros(1, 8, 64, dtype=torch.bfloat16,
                                               device=cuda),
                             torch.ones((1, 8), dtype=torch.bool, device=cuda),
                             denom=1.0)

    @pytest.mark.parametrize("b,S", [(3, 640), (2, 9000)])
    def test_flash_decode_mla_never_reads_masked_slots(self, cuda, b, S):
        """Non-finite c_kv and k_rope in masked slots leave the output bit
        for bit as it was: at S=640 the splits merge in a cluster, at
        S=9000 in a second kernel."""
        rng = np.random.default_rng(10)
        args = [_randn(rng, s, "bfloat16").to(cuda) for s in
                ((b, 128, 512), (b, 128, 64), (b, S, 512), (b, S, 64))]
        _, valid = _decode_inputs(b, S, 1, 1, 32, "float32", seed=11)
        valid = torch.from_numpy(valid).to(cuda)
        clean = flash_decode_mla(*args, valid, denom=14.0)
        c_bad, k_bad = args[2].clone(), args[3].clone()
        c_bad[~valid] = float("nan")
        k_bad[~valid] = float("inf")
        assert torch.equal(flash_decode_mla(args[0], args[1], c_bad, k_bad,
                                            valid, denom=14.0), clean)

    # ------------------------------------------------------ training path --

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("case", ATTN_CASES)
    def test_flash_attention_lse_matches_plain(self, cuda, case, dtype):
        """lse is float32 from float32 scores in either dtype: 2e-5."""
        causal, window = case[6], case[7]
        q, k, v = (t.to(cuda) for t in _attn_inputs(case, dtype))
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        assert torch.equal(o, flash_attention(q, k, v, causal=causal,
                                              window=window))
        want = attention_lse_ref(q, k, causal=causal, window=window)
        assert lse.dtype == torch.float32 and lse.shape == want.shape
        torch.testing.assert_close(lse, want, atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("case", BWD_CASES)
    def test_flash_attention_bwd_matches_plain(self, cuda, case, dtype):
        """max|d| <= tol * max|ref| against the explicit formulas on the same
        o and lse and against autograd through the plain forward, tol the
        forward's (2e-2 bf16: the kernel rounds P and dS to bf16 for the
        tensor cores and dq, dk, dv once, the plain versions once; 2e-5
        fp32: sum order)."""
        causal, window = case[6], case[7]
        kw = dict(causal=causal, window=window)
        q, k, v = (t.to(cuda) for t in _attn_inputs(case, dtype))
        do = _randn(np.random.default_rng(6), q.shape, dtype).to(cuda)
        o, lse = flash_attention_lse(q, k, v, **kw)
        n = LAUNCHES["flash_attention_bwd"]
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert LAUNCHES["flash_attention_bwd"] == n + 1
        want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        attention_ref(*leaves, **kw).backward(do)
        tol = DTYPES[dtype][1]
        for g, w, leaf in zip(got, want, leaves):
            assert g.dtype == w.dtype and g.shape == w.shape
            err = (g.float() - w.float()).abs().max()
            assert err <= tol * w.float().abs().max(), err
            err = (g.float() - leaf.grad.float()).abs().max()
            assert err <= tol * leaf.grad.float().abs().max(), err
        assert all(torch.equal(a, b) for a, b in
                   zip(got, flash_attention_bwd(q, k, v, o, lse, do, **kw)))

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("case", [c for c in WIDE_ATTN_CASES
                                      if c[5] == 192]
                             + [(2, 96, 200, 4, 2, 192, False, 0)])
    def test_flash_attention_bwd_at_head_dim_192(self, cuda, case, dtype):
        """deepseek-v2's MLA training width (the split dK/dV block) against
        the explicit formulas and autograd through the plain forward,
        bit-identical on a rerun, causal with and without a window, GQA and
        sq != sk."""
        self.test_flash_attention_bwd_matches_plain(cuda, case, dtype)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_flash_attention_bwd_at_head_dim_192_rows_with_no_key(self, cuda,
                                                                  dtype):
        """Window 4 over 8 keys leaves rows 11.. of 40 with no key: their
        dq is 0 and every gradient is finite, as the explicit formulas give
        (autograd through the plain forward sees the mean of V there)."""
        kw = dict(causal=True, window=4)
        q, k, v = (t.to(cuda) for t in _attn_inputs(
            (1, 40, 8, 2, 2, 192, True, 4), dtype))
        do = _randn(np.random.default_rng(6), q.shape, dtype).to(cuda)
        o, lse = flash_attention_lse(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert not got[0][:, 11:].any()
        want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g.float()).all())
            err = (g.float() - w.float()).abs().max()
            assert err <= DTYPES[dtype][1] * w.float().abs().max(), err

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("case", BWD_160_CASES)
    def test_flash_attention_bwd_at_head_dim_160(self, cuda, case, dtype):
        """stablelm-12b's training width (the split dK/dV block at 80
        columns a warp group) against the explicit formulas and autograd
        through the plain forward, bit-identical on a rerun: GQA at G = 4,
        MQA, a window and sq != sk."""
        self.test_flash_attention_bwd_matches_plain(cuda, case, dtype)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_flash_attention_bwd_at_head_dim_160_rows_with_no_key(self, cuda,
                                                                  dtype):
        """Window 4 over 8 keys at head dim 160: rows 11.. of 40 see no key
        and get dq = 0; every gradient is finite and within tolerance of the
        explicit formulas."""
        kw = dict(causal=True, window=4)
        q, k, v = (t.to(cuda) for t in _attn_inputs(
            (1, 40, 8, 8, 2, 160, True, 4), dtype))
        do = _randn(np.random.default_rng(6), q.shape, dtype).to(cuda)
        o, lse = flash_attention_lse(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert not got[0][:, 11:].any()
        want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g.float()).all())
            err = (g.float() - w.float()).abs().max()
            assert err <= DTYPES[dtype][1] * w.float().abs().max(), err

    def test_trainable_attention_goes_through_both_kernels(self, cuda):
        q, k, v = (t.to(cuda).requires_grad_(True)
                   for t in _attn_inputs(ATTN_CASES[3], "bfloat16"))
        do = _randn(np.random.default_rng(7), q.shape, "bfloat16").to(cuda)
        before = dict(LAUNCHES)
        o = dispatch.attention(q, k, v)
        o.backward(do)
        assert LAUNCHES["flash_attention"] == before["flash_attention"] + 1
        assert LAUNCHES["flash_attention_bwd"] == \
            before["flash_attention_bwd"] + 1
        with torch.no_grad():
            o2, lse = flash_attention_lse(q, k, v)
            want = flash_attention_bwd(q, k, v, o2, lse, do)
        for g, w in zip((q.grad, k.grad, v.grad), want):
            assert torch.equal(g, w)

    @pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [(37,), (1000,), (64, 130), (4096,)])
    def test_adam_update_matches_plain(self, cuda, shape, param_dtype):
        rng = np.random.default_rng(2)
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        m = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * 0.1
        v = torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32)) * 0.01
        mp = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        g, m, v, mp = (t.to(cuda) for t in (g, m, v, mp))
        kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1, c1=0.5,
                  c2=0.2)
        want = adam_ref(g, m, v, mp, **kw)
        param = torch.empty(shape, dtype=param_dtype, device=cuda)
        n = LAUNCHES["adam_update"]
        adam_update(g, m, v, mp, param, **kw)
        assert LAUNCHES["adam_update"] == n + 1
        for got, w in zip((m, v, mp), want[:3]):
            torch.testing.assert_close(got, w, atol=1e-6, rtol=1e-5)
        # the parameter is the kernel's own master' rounded to its dtype
        assert torch.equal(param, mp.to(param_dtype))

    def test_adam_update_refuses_unaligned(self, cuda):
        buf = torch.zeros(17, device=cuda)
        t = buf[1:]
        with pytest.raises(ValueError, match="aligned"):
            adam_update(t, t.clone(), t.clone(), t.clone(), t.clone(), lr=1e-3,
                        beta1=0.9, beta2=0.95, eps=1e-8, wd=0.0, c1=0.1,
                        c2=0.05)
