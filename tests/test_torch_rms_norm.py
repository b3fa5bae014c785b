"""RMSNorm: the plain version and the gradient of the kernel's autograd op
against the JAX package, the wrapper's checks on the CPU, and -- on a card
only -- the hand-written kernel (``kernels/csrc/rms_norm.cu``) against its
plain version and a decode row alone against the same row in a batch.

On the card, PyTorch's float32 ``mean`` of one row and of the same row
among eight could differ in the last bit (its reduction sizes the thread
block by the row count), and the batchers' greedy tokens left
per-request greedy decoding there: ``chip_smoke.py``'s batch probe named
Mamba2's gated norm.  The kernel sums each row in an order set by its
width alone.  The CPU's reduction happens not to depend on the row
count, so only the ``gpu`` class can show the fault.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, dispatch
from repro_torch.kernels.rms_norm import (rms_norm, rms_norm_bwd_ref,
                                          rms_norm_ref, rms_norm_trainable)
from repro_torch.models.common import gated_rms_norm
from repro_torch.models.common import rms_norm as model_rms_norm

# the norms' widths in the twelve configs: smoke widths, MLA's latent and
# query ranks, d_model and Mamba2's d_inner
WIDTHS = (32, 256, 512, 768, 1536, 3072, 5120, 8192, 16384)
DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}


def _rows(d, b=8, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((3 * rng.standard_normal((b, 1, d))).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", (256, 1536, 5120))
def test_norms_match_jax(d, dtype):
    """rms_norm and gated_rms_norm (the plain versions, which the CPU
    runs) against the JAX package's, fp32 at 2e-6 and bf16 at one bf16
    step of the largest output."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import common as jc
    dt = DTYPES[dtype][0]
    x, z = _rows(d, seed=1, dtype=dt), _rows(d, seed=2, dtype=dt)
    scale = _rows(d, b=1, seed=3, dtype=dt)[0, 0]
    jx, jz, js = (jnp.asarray(t.float().numpy()).astype(dtype) for t in (x, z, scale))
    tol = 2e-6 if dt == torch.float32 else 2 ** -8
    for got, want in ((model_rms_norm(x, scale), jc.rms_norm(jx, js)),
                      (gated_rms_norm(x, z, scale), jc.gated_rms_norm(jx, jz, js))):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=tol * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("d", (256, 1536))
def test_backward_matches_autograd_and_jax(d):
    """The autograd op's backward (rms_norm_bwd_ref from the kernel's row
    scales) against autograd through the plain version and jax.vjp of the
    JAX rms_norm, float32: dx and dscale at 2e-6 of their largest."""
    import jax
    import jax.numpy as jnp
    from repro.models import common as jc
    x, g = _rows(d, b=6, seed=4), _rows(d, b=6, seed=5)
    scale = _rows(d, b=1, seed=6)[0, 0] * 0.5
    rstd = torch.rsqrt(x.square().mean(-1) + 1e-5)
    dx, dscale = rms_norm_bwd_ref(g, x, scale, rstd)
    xl, sl = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    rms_norm_ref(xl, sl).backward(g)
    _, vjp = jax.vjp(jc.rms_norm, jnp.asarray(x.numpy()), jnp.asarray(scale.numpy()))
    jdx, jds = vjp(jnp.asarray(g.numpy()))
    for got, want in ((dx, xl.grad), (dscale, sl.grad), (dx, np.asarray(jdx)),
                      (dscale, np.asarray(jds))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-6 * np.abs(want).max())


def test_dispatch_runs_the_plain_version_on_the_cpu():
    x, scale = _rows(768, dtype=torch.bfloat16), _rows(768, b=1)[0, 0]
    n = LAUNCHES["rms_norm"]
    assert torch.equal(model_rms_norm(x, scale), rms_norm_ref(x, scale))
    assert torch.equal(dispatch.rms_norm(x[..., :512], scale[:512]),
                       rms_norm_ref(x[..., :512], scale[:512]))
    assert LAUNCHES["rms_norm"] == n


def test_wrapper_checks_before_the_device():
    """The wrapper refuses, on any device: inputs that require grad (its
    backward lives in the autograd op), a width that is not whole 16-byte
    chunks, a scale of another width, other dtypes -- and then a CPU
    tensor."""
    x, scale = _rows(64), _rows(64, b=1)[0, 0]
    with pytest.raises(NotImplementedError, match="rms_norm"):
        rms_norm(x.requires_grad_(True), scale)
    with pytest.raises(ValueError, match="multiple of 8"):
        rms_norm(_rows(36, dtype=torch.bfloat16), _rows(36, b=1)[0, 0])
    with pytest.raises(ValueError, match="scale"):
        rms_norm(_rows(64), _rows(32, b=1)[0, 0])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rms_norm(_rows(64).half(), scale)
    with pytest.raises(ValueError, match="CUDA"):
        rms_norm(_rows(64), scale)
    with pytest.raises(ValueError, match="CUDA"):
        rms_norm_trainable(_rows(64), scale)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
class TestRmsNormOnCard:
    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("d", WIDTHS)
    def test_kernel_matches_plain(self, cuda, d, dtype):
        """Output within the kernels' tolerance of the plain version (they
        sum in other orders), rstd within 2e-5, one launch counted, and the
        same bits on a rerun; a bfloat16 x with a float32 scale too."""
        dt, tol = DTYPES[dtype]
        x = _rows(d, b=37, seed=7, dtype=dt).to(cuda)
        for scale in (_rows(d, b=1, seed=8, dtype=dt)[0, 0].to(cuda),
                      _rows(d, b=1, seed=8)[0, 0].to(cuda)):
            n = LAUNCHES["rms_norm"]
            y, rstd = rms_norm(x, scale)
            assert LAUNCHES["rms_norm"] == n + 1
            want = rms_norm_ref(x, scale)
            assert y.dtype == x.dtype and y.shape == x.shape
            assert (y.float() - want.float()).abs().max() <= tol * want.float().abs().max()
            torch.testing.assert_close(
                rstd, torch.rsqrt(x.float().square().mean(-1) + 1e-5),
                atol=0, rtol=2e-5)
            assert torch.equal(rms_norm(x, scale)[0], y)

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("d", WIDTHS)
    def test_row_alone_equals_row_in_batch(self, cuda, d, dtype):
        """The fault the batch probe found, gone: 8 rows at once against
        each alone, through the model's rms_norm and gated_rms_norm, over
        16 draws, bit for bit (Mamba2's gated norm at d_inner 1536 and
        16384, the residual norms at every model width)."""
        dt = DTYPES[dtype][0]
        for seed in range(16):
            x = _rows(d, seed=seed, dtype=dt).to(cuda)
            z = _rows(d, seed=seed + 100, dtype=dt).to(cuda)
            scale = _rows(d, b=1, seed=seed + 200, dtype=dt)[0, 0].to(cuda)
            for fn in (lambda a, b_: model_rms_norm(a, scale),
                       lambda a, b_: gated_rms_norm(a, b_, scale)):
                batch = fn(x, z)
                alone = torch.cat([fn(x[i:i + 1], z[i:i + 1]) for i in range(8)])
                assert torch.equal(batch, alone), (d, seed)

    @pytest.mark.parametrize("d", (768, 5120))
    def test_trainable_op_gradient_matches_plain(self, cuda, d):
        """Through dispatch with grad: the kernel forward (counted) and the
        PyTorch backward, float32, against autograd through the plain
        version at 2e-5; a strided input is made contiguous first."""
        x = _rows(d, b=5, seed=9).to(cuda)
        g = _rows(d, b=5, seed=10).to(cuda)
        scale = (_rows(d, b=1, seed=11)[0, 0] * 0.5).to(cuda)
        grads = []
        for impl in (None, "ref"):
            xl, sl = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
            n = LAUNCHES["rms_norm"]
            with dispatch.force(impl):
                y = dispatch.rms_norm(xl, sl)
            assert LAUNCHES["rms_norm"] == n + (impl is None)
            y.backward(g)
            grads.append((y.detach(), xl.grad, sl.grad))
        for got, want in zip(*grads):
            assert (got - want).abs().max() <= 2e-5 * want.abs().max()
        wide = _rows(2 * d, b=5, seed=12).to(cuda)
        torch.testing.assert_close(dispatch.rms_norm(wide[..., :d], scale),
                                   rms_norm_ref(wide[..., :d], scale),
                                   atol=2e-5, rtol=2e-5)
