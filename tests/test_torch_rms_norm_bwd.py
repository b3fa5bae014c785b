"""The RMSNorm gradient and the gated norm (``kernels/csrc/rms_norm.cu``):
the plain gradients against ``jax.vjp`` of the JAX package's ``rms_norm``
and ``gated_rms_norm`` at the twelve configs' norm widths, the gated
gradient against autograd, the wrappers' allocations on the meta device
(what they allocate on the card), a strided MLA latent slice normed
without a copy, the wrappers' refusals -- and, on a card only, both
kernels against their plain versions: bit-identical reruns (dscale
included), a row alone equal to the same row in a batch, the strided
slice equal to the contiguous rows.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import LAUNCHES, dispatch
from repro_torch.kernels import meta as km
from repro_torch.kernels.rms_norm import (gated_rms_norm_bwd_ref,
                                          gated_rms_norm_ref, rms_norm,
                                          rms_norm_bwd, rms_norm_bwd_ref,
                                          rms_norm_ref)
from repro_torch.models.common import gated_rms_norm

# every norm width of the twelve configs: d_model (gpt2-350m 1,024, gpt2-7b
# 4,096, ...), Mamba2's d_inner (mamba2-130m 1,536, jamba 16,384) and
# MLA's latent ranks (deepseek-v2's kv 512 and q 1,536)
WIDTHS = (512, 768, 1024, 1536, 3072, 4096, 4608, 5120, 6144, 7168, 8192,
          16384)
GATED_WIDTHS = (1536, 16384)
# bf16: both sides round dx (and dz) to bf16 once at the end and du in
# between (2^-8 relative steps); dscale is a float32 sum rounded once.  The
# two frameworks round the gate's product and the chain's intermediates in
# other places (XLA keeps some in float32), so allow two bf16 steps of the
# largest gradient.
TOL = {"float32": (torch.float32, 2e-6), "bfloat16": (torch.bfloat16, 2 ** -7)}
CARD_TOL = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}
BF16 = torch.bfloat16
_ALLOC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
          torch.ops.aten.empty_strided.default}


def _rows(shape, seed, dtype=torch.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal(shape))
                            .astype(np.float32)).to(dtype)


def _inputs(d, dtype, b=4, seed=0):
    x = _rows((b, 1, d), seed, dtype, 3.0)
    z = _rows((b, 1, d), seed + 1, dtype, 2.0)
    g = _rows((b, 1, d), seed + 2, dtype)
    scale = _rows((d,), seed + 3, dtype, 0.5)
    return x, z, g, scale


def _rstd(u):
    return torch.rsqrt(u.float().square().mean(-1) + 1e-5)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("gated,d", [(False, d) for d in WIDTHS]
                         + [(True, d) for d in GATED_WIDTHS])
def test_bwd_refs_match_jax_vjp(gated, d, dtype):
    """rms_norm_bwd_ref / gated_rms_norm_bwd_ref, from the row scales the
    forward writes, against jax.vjp of the JAX package's norms on the same
    numpy-seeded values: float32 at 2e-6 of the largest gradient, bfloat16
    at two bf16 steps (``TOL``)."""
    import jax
    import jax.numpy as jnp
    from repro.models import common as jc
    dt, tol = TOL[dtype]
    x, z, g, scale = _inputs(d, dt, seed=d)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(dtype)  # noqa: E731
    if gated:
        u = x * torch.nn.functional.silu(z.float()).to(dt)
        got = gated_rms_norm_bwd_ref(g, x, z, scale, _rstd(u))
        _, vjp = jax.vjp(jc.gated_rms_norm, j(x), j(z), j(scale))
    else:
        got = rms_norm_bwd_ref(g, x, scale, _rstd(x))
        _, vjp = jax.vjp(jc.rms_norm, j(x), j(scale))
    want = vjp(j(g))
    assert len(got) == len(want)
    for a, w, like in zip(got, want, (x, z, scale) if gated else (x, scale)):
        assert a.dtype == like.dtype and a.shape == like.shape
        _close(a.float().numpy(), w.astype(jnp.float32), tol)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("d", (64, 1536))
def test_gated_bwd_ref_matches_autograd(d, dtype):
    """gated_rms_norm_bwd_ref against autograd through gated_rms_norm_ref
    (the chain the card's plain path differentiates): float32 at 2e-6,
    bfloat16 at one bf16 step of the largest gradient (both round du and
    the product's gradients to bf16; autograd's du comes from the mean's
    graph, not the closed form)."""
    dt, tol = TOL[dtype]
    tol = min(tol, 2 ** -8)
    x, z, g, scale = _inputs(d, dt, b=6, seed=7)
    leaves = [t.clone().requires_grad_(True) for t in (x, z, scale)]
    gated_rms_norm_ref(*leaves).backward(g)
    u = x * torch.nn.functional.silu(z.float()).to(dt)
    got = gated_rms_norm_bwd_ref(g, x, z, scale, _rstd(u))
    for a, leaf in zip(got, leaves):
        assert a.dtype == leaf.grad.dtype
        _close(a.float().numpy(), leaf.grad.float().numpy(), tol)


def test_dispatch_gated_on_the_cpu_is_the_plain_version():
    """On the CPU the gated norm is the plain formula (nothing launched),
    its gradient autograd's."""
    x, z, _, scale = _inputs(768, BF16)
    n = dict(LAUNCHES)
    assert torch.equal(gated_rms_norm(x, z, scale),
                       rms_norm_ref(x * torch.nn.functional.silu(z.float())
                                    .to(BF16), scale))
    assert LAUNCHES == n


class _Allocs(TorchDispatchMode):
    """Every tensor an op allocates, (shape, dtype), and every op's name."""

    def __init__(self):
        super().__init__()
        self.made, self.ops = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append(func)
        if func in _ALLOC:
            self.made.append((tuple(out.shape), out.dtype))
        return out


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("gated", (False, True))
@pytest.mark.parametrize("rows,d", ((1024, 3072), (8, 16384), (1024, 1536),
                                    (37, 768)))
def test_meta_wrappers_allocate_the_card_tensors(rows, d, gated):
    """On meta the wrappers allocate exactly what they allocate on the
    card -- the forward y and rstd; the gradient dx (dz), the (blocks, d)
    float32 scratch of dscale's partial sums and dscale -- and nothing
    else, counting no launch."""
    x, z, g = _meta(rows, d), _meta(rows, d), _meta(rows, d)
    scale = _meta(d, dtype=torch.float32)
    zz = z if gated else None
    n = dict(LAUNCHES)
    with _Allocs() as al:
        y, rstd = rms_norm(x, scale, z=zz)
    assert al.made == [((rows, d), BF16), ((rows,), torch.float32)]
    blocks = km.rms_norm_bwd_blocks(rows, d)
    with _Allocs() as al:
        grads = rms_norm_bwd(g, x, scale, rstd, z=zz)
    assert al.made == [((rows, d), BF16)] * (1 + gated) + [
        ((blocks, d), torch.float32), ((d,), torch.float32)]
    assert [t.shape for t in grads] == [x.shape] * (1 + gated) + [scale.shape]
    assert LAUNCHES == n


@pytest.mark.parametrize("rows,d,blocks", (
        (1024, 3072, 128), (4096, 3072, 128), (1024, 1536, 128),
        (1024, 16384, 128), (8, 3072, 2), (8, 16384, 8), (1, 512, 1),
        (37, 768, 5)))
def test_bwd_blocks_follow_rows_and_width(rows, d, blocks):
    """The gradient's blocks: one a row group while that fits the H100's
    132, else equal ranges of rows -- from (rows, d) alone; each launch
    holds at most 256 threads and a row's 64 values a thread."""
    assert km.rms_norm_bwd_blocks(rows, d) == blocks
    warps, per_block = km.rms_norm_plan(d)
    assert 32 * warps * per_block <= 256 and d <= 32 * warps * 64


@pytest.mark.parametrize("rows,d,per_block", (
        (4096, 3072, 4), (1024, 3072, 4), (8, 3072, 1), (1024, 1536, 7),
        (1055, 768, 7), (1056, 768, 8), (8, 16384, 1), (1024, 16384, 1)))
def test_fwd_plan_keeps_a_rows_warps(rows, d, per_block):
    """The forward's launch: the warps a row are ``rms_norm_plan(d)``'s
    whatever the row count (a row's sums follow them alone); no more
    rows a block than leave a block for each of 132 SMs."""
    warps, got = km.rms_norm_fwd_plan(rows, d)
    assert warps == km.rms_norm_plan(d)[0] and got == per_block


def test_strided_latent_slice_is_normed_in_place():
    """MLA's kv[..., :r_kv] (rows 576 apart): no copy before the kernel
    (on meta, the forward's ops are the wrapper's allocations alone, with
    and without a gradient to take), and the plain version on the CPU
    gives the contiguous rows' result."""
    kv = _meta(2, 5, 576)
    scale = _meta(512, dtype=torch.float32)
    for x in (kv[..., :512], kv.clone().requires_grad_(True)[..., :512]):
        with _Allocs() as al:
            y = dispatch.rms_norm(x, scale)
            assert not (set(al.ops) - _ALLOC), al.ops
            if y.requires_grad:
                y.sum().backward()
        assert y.shape == (2, 5, 512)
    cpu = _rows((2, 5, 576), 3, BF16, 3.0)
    s = _rows((512,), 4, scale=0.5)
    assert torch.equal(dispatch.rms_norm(cpu[..., :512], s),
                       rms_norm_ref(cpu[..., :512].contiguous(), s))


@pytest.mark.parametrize("case", [
    "grad", "bwd_g_shape", "bwd_g_strided", "bwd_rstd_dtype", "z_dtype",
    "too_wide", "uneven_rows", "row_stride_off_grid", "last_axis_strided",
    "cpu"])
def test_wrappers_refuse(case):
    """The wrappers raise on what the kernels do not take -- checked on meta
    tensors, as on the card -- and on CPU tensors."""
    x, g = _meta(8, 512), _meta(8, 512)
    scale, rstd = _meta(512), _meta(8, dtype=torch.float32)
    if case == "grad":
        with pytest.raises(NotImplementedError, match="rms_norm"):
            rms_norm(x.requires_grad_(True), scale)
    elif case == "bwd_g_shape":
        with pytest.raises(ValueError, match="g of x's shape"):
            rms_norm_bwd(_meta(8, 256), x, scale, rstd)
    elif case == "bwd_g_strided":
        with pytest.raises(ValueError, match="contiguous g"):
            rms_norm_bwd(_meta(8, 1024)[:, :512], x, scale, rstd)
    elif case == "bwd_rstd_dtype":
        with pytest.raises(ValueError, match="float32 rstd"):
            rms_norm_bwd(g, x, scale, _meta(8))
    elif case == "z_dtype":
        with pytest.raises(ValueError, match="gate z"):
            rms_norm(x, scale, z=_meta(8, 512, dtype=torch.float32))
    elif case == "too_wide":
        with pytest.raises(ValueError, match="widest row"):
            rms_norm(_meta(2, 16392), _meta(16392))
    elif case == "uneven_rows":
        with pytest.raises(ValueError, match="evenly"):
            rms_norm(_meta(4, 6, 576)[:, :5, :512], scale)
    elif case == "row_stride_off_grid":
        with pytest.raises(ValueError, match="16-byte grid"):
            rms_norm(_meta(8, 516)[:, :512], scale)
    elif case == "last_axis_strided":
        with pytest.raises(ValueError, match="contiguous last axis"):
            rms_norm(_meta(512, 8).t(), scale)
    else:
        cx = torch.zeros(8, 512)
        with pytest.raises(ValueError, match="CUDA"):
            rms_norm_bwd(cx, cx, torch.ones(512), torch.ones(8))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
class TestRmsNormBwdOnCard:
    @pytest.mark.parametrize("dtype", list(CARD_TOL))
    @pytest.mark.parametrize("gated,rows,d", [
        (False, 1024, 3072), (False, 37, 768), (False, 8, 5120),
        (False, 64, 16384), (True, 1024, 1536), (True, 256, 16384),
        (True, 37, 768)])
    def test_bwd_kernel_matches_plain(self, cuda, gated, rows, d, dtype):
        """dx, dz and dscale within the kernels' tolerance of the plain
        gradient, one launch counted, and the same bits on a rerun (dscale
        included: its blocks and their order follow (rows, d) alone)."""
        dt, tol = CARD_TOL[dtype]
        x, z, g, _ = (t.to(cuda) for t in _inputs(d, dt, b=rows, seed=rows))
        scale = _rows((d,), 5, scale=0.5).to(cuda)
        zz = z if gated else None
        _, rstd = rms_norm(x, scale, z=zz)
        n = LAUNCHES["rms_norm_bwd"]
        got = rms_norm_bwd(g, x, scale, rstd, z=zz)
        assert LAUNCHES["rms_norm_bwd"] == n + 1
        want = (gated_rms_norm_bwd_ref(g, x, z, scale, rstd) if gated
                else rms_norm_bwd_ref(g, x, scale, rstd))
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and a.shape == w.shape
            assert (a.float() - w.float()).abs().max() <= tol * w.float().abs().max()
        again = rms_norm_bwd(g, x, scale, rstd, z=zz)
        assert all(torch.equal(a, b) for a, b in zip(got, again))

    @pytest.mark.parametrize("dtype", list(CARD_TOL))
    @pytest.mark.parametrize("d", (768, 1536, 16384))
    def test_gated_forward_matches_plain_and_is_batch_invariant(self, cuda, d,
                                                                dtype):
        """The gated kernel within tolerance of gated_rms_norm_ref, its rstd
        that of the rounded product, and 8 rows at once equal to each alone
        bit for bit."""
        dt, tol = CARD_TOL[dtype]
        x, z, _, scale = (t.to(cuda) for t in _inputs(d, dt, b=8, seed=d))
        y, rstd = rms_norm(x, scale, z=z)
        want = gated_rms_norm_ref(x, z, scale)
        assert (y.float() - want.float()).abs().max() <= tol * want.float().abs().max()
        u = x * torch.nn.functional.silu(z.float()).to(dt)
        torch.testing.assert_close(rstd, _rstd(u), atol=0, rtol=2e-5)
        alone = torch.cat([rms_norm(x[i:i + 1], scale, z=z[i:i + 1])[0]
                           for i in range(8)])
        assert torch.equal(alone, y)

    def test_strided_slice_equals_contiguous(self, cuda):
        """MLA's kv[..., :512] read in place: the forward's y and rstd and
        the gradient's dx and dscale equal those of the contiguous copy, bit
        for bit."""
        kv = _rows((2, 512, 576), 11, BF16, 3.0).to(cuda)
        scale = _rows((512,), 12, scale=0.5).to(cuda)
        g = _rows((2, 512, 512), 13, BF16).to(cuda)
        flat = kv[..., :512].contiguous()
        y, rstd = rms_norm(kv[..., :512], scale)
        y2, rstd2 = rms_norm(flat, scale)
        assert torch.equal(y, y2) and torch.equal(rstd, rstd2)
        for a, b in zip(rms_norm_bwd(g, kv[..., :512], scale, rstd),
                        rms_norm_bwd(g, flat, scale, rstd)):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("gated", (False, True))
    def test_trainable_ops_match_plain_autograd(self, cuda, gated):
        """Through dispatch with grad, float32: the forward and gradient
        kernels (each counted once) against autograd through the plain
        version at 2e-5 of the largest gradient."""
        d = 1536
        x, z, g, scale = (t.to(cuda) for t in _inputs(d, torch.float32, b=5))
        fn = ((lambda a, b, s: dispatch.gated_rms_norm(a, b, s)) if gated
              else (lambda a, b, s: dispatch.rms_norm(a, s)))
        grads = []
        for impl in (None, "ref"):
            leaves = [t.clone().requires_grad_(True) for t in (x, z, scale)]
            n = dict(LAUNCHES)
            with dispatch.force(impl):
                fn(*leaves).backward(g)
            k = impl is None
            assert (LAUNCHES["rms_norm"], LAUNCHES["rms_norm_bwd"]) == (
                n["rms_norm"] + k, n["rms_norm_bwd"] + k)
            grads.append([t.grad for t in leaves if t.grad is not None])
        for a, w in zip(*grads):
            assert (a - w).abs().max() <= 2e-5 * w.abs().max()
