"""The port's SSD scan and its gradient: the plain versions against the JAX
package's Pallas kernel (interpret mode), its ``ssd_ref`` oracle and
``jax.vjp`` of its chunked scan, dispatch by device, the wrappers' checks,
and -- on a card only -- the hand-written CUDA kernels against their plain
versions and the autograd op that joins them.

Inputs are drawn with numpy from a fixed seed; bfloat16 inputs are rounded
once in torch and handed to JAX through float32, which is exact, so both
sides see the same bits.  Tolerances are the JAX package's own SSD kernel
tolerances, 2e-3 in float32 and 5e-2 in bfloat16, absolute and relative
(tests/test_kernels.py::test_ssd_scan_sweep).

JAX is imported by the ``jx`` fixture, not at module level: the card's
machine has no JAX, and the ``gpu`` class runs there.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, dispatch
from repro_torch.kernels.ssd_scan import (ssd_chunked, ssd_naive, ssd_scan,
                                          ssd_scan_bwd, ssd_scan_bwd_ref,
                                          ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ssd_scan import (SHAPES, bwd_scratch, chunk,
                                                   segment_chunks)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's tests, restored after: the CPU
    ops here are small, and a pool of spinning threads per test process
    only crowds the other processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"float32": (torch.float32, 2e-3), "bfloat16": (torch.bfloat16, 5e-2)}

# the shapes of tests/test_kernels.py::test_ssd_scan_sweep: (b, s, h, p, n,
# chunk)
SSD_CASES = [
    (2, 128, 3, 32, 16, 32),
    (1, 100, 2, 16, 8, 32),                   # padded tail chunk
    (2, 256, 4, 64, 128, 128),                # production-like dims
    (1, 64, 24, 64, 128, 64),                 # mamba2-130m head count
]
# a length the JAX package's chunked scan refuses at chunk 128 (200 % 128)
RAGGED = (2, 200, 3, 32, 16, 128)
# the gradient against jax.vjp: (b, s, h, p, n) at the smoke and the full
# (P, N) and two lengths
BWD_CASES = [(2, 128, 3, 32, 16), (2, 256, 3, 32, 16), (1, 128, 4, 64, 128),
             (1, 256, 4, 64, 128)]
BWD_NAMES = ("dx", "ddt_raw", "dA_log", "dB", "dC", "dD", "ddt_bias")
# the gradient in float32, max |d| <= BWD_TOL * max |ref| per gradient: the
# two sides sum the same chunked terms in other orders; dA_log, a sum over
# every (position, p, n), has the least headroom (1.3e-5 observed)
BWD_TOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's SSD kernel, oracle and chunked scan."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ssd_ref, ssd_scan as pallas_ssd_scan
    from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
    return SimpleNamespace(jax=jax, jnp=jnp, ssd_ref=ssd_ref,
                           ssd_scan=pallas_ssd_scan,
                           ssd_chunked=jax_ssd_chunked)


def _inputs(b, s, h, p, n, dtype, seed=1, device="cpu"):
    """x, dt_raw, A_log, B, C, D, dt_bias as in the JAX sweep: x, B, C
    standard normal, dt_raw N(0, 0.25), A_log N(0, 0.09), D N(0, 1) and
    dt_bias 0.1; x, dt_raw, B, C rounded to ``dtype``, the rest float32."""
    rng = np.random.default_rng(seed)
    dt = DTYPES[dtype][0]

    def arr(shape, scale=1.0, to=dt):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * scale).to(device=device, dtype=to)

    x = arr((b, s, h, p))
    dt_raw = arr((b, s, h), 0.5)
    A_log = arr((h,), 0.3, torch.float32)
    B, C = arr((b, s, n)), arr((b, s, n))
    D = arr((h,), 1.0, torch.float32)
    dt_bias = torch.full((h,), 0.1, device=device)
    return x, dt_raw, A_log, B, C, D, dt_bias


def _to_jax(jx, t):
    """A torch tensor as a JAX array of the same dtype and bits."""
    return jx.jnp.asarray(t.float().numpy()).astype(str(t.dtype)[6:])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _jax_oracle(jx, args):
    """The JAX package's sequential recurrence on the inputs widened to
    float32, after the same softplus and A = -exp(A_log)."""
    jnp = jx.jnp
    x, dt_raw, A_log, B, C, D, dt_bias = (_to_jax(jx, t) for t in args)
    dt = jx.jax.nn.softplus(dt_raw.astype(jnp.float32) + dt_bias)
    return jx.ssd_ref(x.astype(jnp.float32), dt, -jnp.exp(A_log),
                      B.astype(jnp.float32), C.astype(jnp.float32), D)


def _assert_close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=tol, rtol=tol)


# ------------------------------------------------ plain versions vs JAX --

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES + [RAGGED],
                         ids=lambda c: "b{}_s{}_h{}_p{}_n{}_L{}".format(*c))
def test_ssd_scan_ref_matches_pallas_kernel(jx, case, dtype):
    b, s, h, p, n, chunk = case
    args = _inputs(b, s, h, p, n, dtype)
    got = ssd_scan_ref(*args, chunk=chunk)
    want = jx.ssd_scan(*(_to_jax(jx, t) for t in args), chunk=chunk,
                       interpret=True)
    assert got[0].dtype == args[0].dtype and got[1].dtype == torch.float32
    assert tuple(got[1].shape) == (b, h, p, n)
    _assert_close(got, want, DTYPES[dtype][1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES + [RAGGED],
                         ids=lambda c: "b{}_s{}_h{}_p{}_n{}_L{}".format(*c))
def test_ssd_scan_ref_matches_the_recurrence(jx, case, dtype):
    b, s, h, p, n, chunk = case
    args = _inputs(b, s, h, p, n, dtype, seed=2)
    _assert_close(ssd_scan_ref(*args, chunk=chunk), _jax_oracle(jx, args),
                  DTYPES[dtype][1])


def test_the_reference_chunked_scan_refuses_a_ragged_length(jx):
    """Where the port pads (above), the JAX package's ``ssd_chunked`` --
    its CPU path for the SSD op -- asserts s % chunk == 0."""
    b, s, h, p, n, chunk = RAGGED
    x, dt_raw, A_log, B, C, D, dt_bias = (
        _to_jax(jx, t) for t in _inputs(b, s, h, p, n, "float32"))
    with pytest.raises(AssertionError):
        jx.ssd_chunked(x, jx.jax.nn.softplus(dt_raw + dt_bias),
                       -jx.jnp.exp(A_log), B, C, D, chunk=chunk)


def test_ssd_naive_matches_jax_ssd_ref(jx):
    x, dt_raw, A_log, B, C, D, dt_bias = _inputs(2, 37, 3, 16, 8, "float32")
    dt = F.softplus(dt_raw + dt_bias)
    got = ssd_naive(x, dt, -torch.exp(A_log), B, C, D)
    _assert_close(got, _jax_oracle(jx, (x, dt_raw, A_log, B, C, D, dt_bias)),
                  1e-5)


@pytest.mark.parametrize("chunk", [1, 16, 64, 100, 128, 512])
def test_ssd_chunked_is_exact_at_any_chunk(chunk):
    """Chunking, the padded tail included, is exact in math: at s=100 every
    chunk length agrees with the recurrence to float32 rounding."""
    x, dt_raw, A_log, B, C, D, dt_bias = _inputs(2, 100, 3, 16, 8, "float32")
    dt = F.softplus(dt_raw + dt_bias)
    A = -torch.exp(A_log)
    _assert_close(ssd_chunked(x, dt, A, B, C, D, chunk=chunk),
                  ssd_naive(x, dt, A, B, C, D), 1e-4)


# ------------------------------------------------------------- the gradient --

def _cotangents(y_shape, state_shape, with_state, seed=3):
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal(y_shape).astype(np.float32)
    ds = (rng.standard_normal(state_shape).astype(np.float32) if with_state
          else None)
    return dy, ds


def _assert_grads_close(got, want, tol=BWD_TOL):
    """max |d| <= tol * max |ref| per gradient (a gradient that is 0 in
    math, as dA_log at one row, must come out 0)."""
    for name, g, w in zip(BWD_NAMES, got, want):
        g, w = _f32(g), _f32(w)
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: "b{}_s{}_h{}_p{}_n{}".format(*c))
def test_ssd_scan_bwd_ref_matches_jax_vjp(jx, case, with_state):
    """The explicit chunked backward (chunks of 32) against jax.vjp of the
    JAX package's SSD path -- softplus(dt_raw + dt_bias), A = -exp(A_log),
    ``ssd_chunked`` at chunk 64 -- with a cotangent on the final state or
    none."""
    b, s, h, p, n = case
    args = _inputs(b, s, h, p, n, "float32")
    dy, ds = _cotangents((b, s, h, p), (b, h, p, n), with_state)
    jnp = jx.jnp

    def path(x, dt_raw, A_log, B, C, D, dt_bias):
        return jx.ssd_chunked(x, jx.jax.nn.softplus(dt_raw + dt_bias),
                              -jnp.exp(A_log), B, C, D, chunk=64)

    (_, state), vjp = jx.jax.vjp(path, *(_to_jax(jx, t) for t in args))
    want = vjp((jnp.asarray(dy), jnp.zeros_like(state) if ds is None
                else jnp.asarray(ds)))
    got = ssd_scan_bwd_ref(*args, torch.from_numpy(dy),
                           None if ds is None else torch.from_numpy(ds),
                           chunk=32)
    assert [t.dtype for t in got] == [torch.float32] * 7
    _assert_grads_close(got, want)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_bwd_ref_matches_autograd_at_a_ragged_length(with_state):
    """s = 200, where the JAX path asserts: against torch's autograd through
    the port's ``ssd_chunked`` (``ssd_scan_ref``), both padding the tail."""
    b, s, h, p, n, chunk = RAGGED
    args = [t.requires_grad_(True) for t in _inputs(b, s, h, p, n, "float32")]
    y, state = ssd_scan_ref(*args, chunk=chunk)
    dy, ds = (None if a is None else torch.from_numpy(a)
              for a in _cotangents(y.shape, state.shape, with_state))
    loss = (y * dy).sum() + (0 if ds is None else (state * ds).sum())
    want = torch.autograd.grad(loss, args)
    got = ssd_scan_bwd_ref(*(t.detach() for t in args), dy, ds, chunk=chunk)
    _assert_grads_close(got, want)


def test_ssd_scan_bwd_ref_keeps_the_input_dtypes():
    args = _inputs(1, 70, 2, 32, 16, "bfloat16")
    dy = torch.ones((1, 70, 2, 32), dtype=torch.bfloat16)
    got = ssd_scan_bwd_ref(*args, dy)
    assert [t.dtype for t in got] == [torch.bfloat16] * 2 + [torch.float32] \
        + [torch.bfloat16] * 2 + [torch.float32] * 2
    assert [tuple(g.shape) for g in got] == [tuple(a.shape) for a in args]
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)


def _hilo(v):
    """A float32 tensor as the kernel feeds it to the tensor cores: bf16
    halves hi = bf16(v) and lo = bf16(v - hi), both widened back."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _bf16_only(v):
    """A float32 operand rounded once to bf16, its lo half dropped."""
    return v.bfloat16().float(), torch.zeros_like(v)


def _emulated_bwd_kernel(x, dt_raw, A_log, B, C, D, dt_bias, dy, d_state=None,
                         L=64, split=_hilo):
    """The bfloat16 body of ``csrc/ssd_scan_bwd.cu`` in torch, term for term
    at its operands' rounding: bf16 operands (x, dy, B, C) as they are;
    every float32 operand of a product as hi + lo (w o x and e o dy, M, the
    heads' summed Q, the states S and G), with hi.hi + hi.lo + lo.hi where
    both operands are float32; C.B^T once per (batch, chunk), shared by the
    heads; Q summed over the heads before its products with B and C.  The
    sums are float32, in torch's order rather than the mma's.  Returns the
    seven gradients in float32.  ``split`` makes a float32 operand's two
    halves (``_bf16_only`` keeps the hi half alone)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    s_p = -(-s // L) * L
    nc = s_p // L
    xf, dyf, Bf, Cf = (t.float() for t in (x, dy, B, C))
    r = dt_raw.float() + dt_bias
    dt = F.softplus(r)
    A = -torch.exp(A_log)
    if s_p != s:
        xf, dyf = (F.pad(t, (0, 0, 0, 0, 0, s_p - s)) for t in (xf, dyf))
        Bf, Cf, dt = (F.pad(t, (0, 0, 0, s_p - s)) for t in (Bf, Cf, dt))
    xc, dyc = xf.reshape(b, nc, L, h, p), dyf.reshape(b, nc, L, h, p)
    Bc, Cc = Bf.reshape(b, nc, L, n), Cf.reshape(b, nc, L, n)
    dtc = dt.reshape(b, nc, L, h)
    cum = torch.cumsum(dtc * A, dim=2)
    last = cum[:, :, -1]
    e = torch.exp(cum)
    te = torch.exp(last[:, :, None] - cum)
    w = dtc * te

    # ssd_bwd_chunk_mma: the chunks' state products, the scaled x and dy as
    # hi + lo against bf16 B and C; C.B^T once per (batch, chunk)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    wx_h, wx_l = split(w[..., None] * xc)
    ed_h, ed_l = split(e[..., None] * dyc)
    upd = torch.einsum("bclhp,bcln->bchpn", wx_h + wx_l, Bc)
    dfy = torch.einsum("bclhp,bcln->bchpn", ed_h + ed_l, Cc)
    # ssd_bwd_pass<true>, float32; it leaves the states as hi + lo
    run = torch.zeros((b, h, p, n))
    S = []
    for c in range(nc):
        S.append(run)
        run = run * torch.exp(last[:, c])[:, :, None, None] + upd[:, c]
    S = torch.stack(S, dim=1)
    run = torch.zeros_like(run) if d_state is None else d_state.float()
    G = [None] * nc
    for c in reversed(range(nc)):
        G[c] = run
        run = run * torch.exp(last[:, c])[:, :, None, None] + dfy[:, c]
    G = torch.stack(G, dim=1)

    # ssd_bwd_grads_mma
    Gh, Gl = split(G)
    Sh, Sl = split(S)
    gs = ((Gh + Gl) * (Sh + Sl)).sum((3, 4))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.ones((L, L), dtype=torch.bool).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg, -1e9))
    dyx = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    M = cb[..., None] * decay
    Q = dyx * decay * dtc[:, :, None]
    z = M * dyx
    zr = (z * dtc[:, :, None]).sum(3)
    col = z.sum(2)
    # warps 0-3: G B_j, sum_i M_ij dy_i, dx, the heads' (w o x) G
    GB = torch.einsum("bcjn,bchpn->bcjhp", Bc, Gh + Gl)
    u = (xc * GB).sum(-1)
    Mh, Ml = split(M)
    dm = torch.einsum("bcijh,bcihp->bcjhp", Mh + Ml, dyc)
    dx = dtc[..., None] * (dm + te[..., None] * GB) + D[:, None] * dyc
    dB = (torch.einsum("bcjhp,bchpn->bcjn", wx_h, Gh + Gl)
          + torch.einsum("bcjhp,bchpn->bcjn", wx_l, Gh))
    # warps 4-7: S C_i, yo, the heads' (e o dy) S
    SC = torch.einsum("bcin,bchpn->bcihp", Cc, Sh + Sl)
    yo = e * (dyc * SC).sum(-1)
    dC = (torch.einsum("bcihp,bchpn->bcin", ed_h, Sh + Sl)
          + torch.einsum("bcihp,bchpn->bcin", ed_l, Sh))
    # Q summed over the heads, then its products with C and B
    Qh, Ql = split(Q.sum(-1))
    dB = dB + torch.einsum("bcij,bcin->bcjn", Qh + Ql, Cc)
    dC = dC + torch.einsum("bcij,bcjn->bcin", Qh + Ql, Bc)
    # warp 0: the vectors
    dcum = zr - dtc * col + yo - w * u
    base = torch.exp(last) * gs + (w * u).sum(2)
    da = (torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
          + base[:, :, None])
    ddt = col + te * u + A * da
    dA = (dtc * da).sum((0, 1, 2))
    dr = ddt.reshape(b, s_p, h)[:, :s] * torch.sigmoid(r)
    dD = torch.einsum("bciih->h", dyx)
    return (dx.reshape(b, s_p, h, p)[:, :s], dr, dA * A,
            dB.reshape(b, s_p, n)[:, :s], dC.reshape(b, s_p, n)[:, :s], dD,
            dr.sum((0, 1)))


# the emulated kernel's error limit, ~10x the largest measured (9.3e-06):
# far below the bf16 tolerance, so a design that lost the lo halves fails
EMULATED_BWD_TOL = 1e-4
KERNEL_ROUNDING_CASES = pytest.mark.parametrize(
    "case", [(1, 1024, 24, 64, 128), (2, 200, 16, 32, 16)],
    ids=["train", "smoke_dims"])


def _emulated_vs_ref(case, with_state, split=_hilo):
    """The emulated kernel and ``ssd_scan_bwd_ref`` in float32 on the same
    bf16 inputs."""
    b, s, h, p, n = case
    args = _inputs(b, s, h, p, n, "bfloat16")
    dy, ds = _cotangents((b, s, h, p), (b, h, p, n), with_state)
    dy = torch.from_numpy(dy).bfloat16()
    ds = None if ds is None else torch.from_numpy(ds)
    got = _emulated_bwd_kernel(*args, dy, ds, split=split)
    want = ssd_scan_bwd_ref(*(t.float() for t in args), dy.float(), ds)
    return got, want


@pytest.mark.parametrize("with_state", [False, True])
@KERNEL_ROUNDING_CASES
def test_ssd_scan_bwd_kernel_rounding_holds_the_bf16_tolerance(case,
                                                               with_state):
    """The bfloat16 gradient kernel's numerical design, where no compiler
    exists: its operand rounding (float32 operands as bf16 hi + lo, C.B^T
    shared by the heads, Q summed over the heads first) emulated in torch
    against ``ssd_scan_bwd_ref`` in float32 on the same bf16 inputs, max |d|
    <= 5e-2 * max |ref| per gradient, the bf16 tolerance, and within
    ``EMULATED_BWD_TOL``.  Measured, worst gradient dA_log: 9.3e-06
    (training shape) and 7.6e-06 (smoke dims), the others at most 5.5e-06:
    the hi + lo halves keep ~16 bits, and the kernel's error is the bf16
    rounding of its outputs."""
    got, want = _emulated_vs_ref(case, with_state)
    _assert_grads_close(got, want, DTYPES["bfloat16"][1])
    _assert_grads_close(got, want, EMULATED_BWD_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@KERNEL_ROUNDING_CASES
def test_ssd_scan_bwd_kernel_rounding_needs_the_lo_halves(case, with_state):
    """The same emulation with every float32 operand rounded once to bf16
    (no lo halves) misses ``EMULATED_BWD_TOL`` in each gradient whose
    products take a float32 operand (all but dD, a sum of bf16 x bf16
    products): measured 3.4e-04 to 3.1e-03 of max |ref|.  So the limit
    catches a kernel that drops the split."""
    got, want = _emulated_vs_ref(case, with_state, split=_bf16_only)
    for name, g, w in zip(BWD_NAMES, got, want):
        if name == "dD":
            continue
        err = np.abs(_f32(g) - _f32(w)).max() / np.abs(_f32(w)).max()
        assert err > EMULATED_BWD_TOL, (name, err)


def test_ssd_scan_bwd_scratch_has_no_per_head_rows():
    """The gradient's scratch plan: in bfloat16 no (b, s, h, n) float32
    array (the heads' dB and dC are summed on chip) and C.B^T once per
    (batch, chunk); at mamba2-130m's training microbatch 25,434,112 B, half
    the float32 body's 50,337,792."""
    def nbytes(plan):
        return sum(4 * int(np.prod(shape)) for shape in plan.values())

    b, s, h, p, n = 1, 1024, 24, 64, 128
    plan = bwd_scratch(b, s, h, p, n, torch.bfloat16, 64)
    assert (b, s, h, n) not in plan.values()
    assert plan["cb"] == (b, 16, 64, 64)
    assert nbytes(plan) == 25_434_112
    fp32 = bwd_scratch(b, s, h, p, n, torch.float32, 64)
    assert fp32["dbp"] == fp32["dcp"] == (b, s, h, n) and "cb" not in fp32
    assert nbytes(fp32) == 50_337_792


def test_ssd_scan_bwd_refuses_what_it_does_not_take():
    """The gradient wrapper's checks, before the device check."""
    args = list(_inputs(1, 8, 2, 64, 128, "float32"))
    dy = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd(*args, dy)
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd(*args, dy[:, :4])
    with pytest.raises(ValueError, match="d_state"):
        ssd_scan_bwd(*args, dy, torch.zeros((1, 2, 64, 128),
                                            dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"\(16, 8\) not in"):
        ssd_scan_bwd(*_inputs(1, 8, 2, 16, 8, "float32"),
                     torch.zeros((1, 8, 2, 16)))
    with pytest.raises(NotImplementedError, match="second derivative"):
        ssd_scan_bwd(*args, dy.requires_grad_(True))


# ---------------------------------------------------------------- dispatch --

def test_dispatch_ssd_on_cpu_runs_the_plain_version():
    before = dict(LAUNCHES)
    args = _inputs(1, 100, 2, 32, 16, "bfloat16")
    want = ssd_scan_ref(*args)
    for got in (dispatch.ssd(*args), ssd_scan_ref(*args, chunk=128)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with dispatch.force("ref"):
        got = dispatch.ssd(*args, chunk=32)
    assert all(torch.equal(g, w) for g, w in
               zip(got, ssd_scan_ref(*args, chunk=32)))
    assert LAUNCHES == before


def test_dispatch_ssd_on_cpu_differentiates_the_plain_version():
    """With grad on, a CPU tensor takes the plain version, whose gradient is
    PyTorch's autograd (a CUDA tensor takes the autograd op of the two
    kernels): every input that requires grad gets a finite gradient."""
    before = dict(LAUNCHES)
    args = [t.requires_grad_(True)
            for t in _inputs(1, 100, 2, 32, 16, "float32")]
    y, state = dispatch.ssd(*args)
    assert y.grad_fn is not None and state.grad_fn is not None
    (y.square().sum() + state.sum()).backward()
    for t in args:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
    assert LAUNCHES == before


def test_ssd_scan_refuses_what_it_does_not_take():
    """Shape, dtype and (P, N) checks come before the device check, so
    they hold on the CPU; a supported CPU call is refused for its device."""
    args = list(_inputs(1, 8, 2, 64, 128, "float32"))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(*args)
    with pytest.raises(ValueError, match=r"\(16, 8\) not in"):
        ssd_scan(*_inputs(1, 8, 2, 16, 8, "float32"))
    bad = list(args)
    bad[3] = bad[3].to(torch.bfloat16)                    # B
    with pytest.raises(TypeError, match="one dtype"):
        ssd_scan(*bad)
    bad = list(args)
    bad[2] = bad[2].to(torch.bfloat16)                    # A_log
    with pytest.raises(TypeError, match="float32 A_log"):
        ssd_scan(*bad)
    bad = list(args)
    bad[1] = bad[1][:, :4]                                # dt_raw
    with pytest.raises(ValueError, match="do not agree"):
        ssd_scan(*bad)
    # mamba2-130m's, a model rank's of it at t = 16 (32 of each head's 64
    # channels) and the smoke config's
    assert set(SHAPES) == {(32, 16), (32, 128), (64, 128)}
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(*_inputs(1, 8, 3, 32, 128, "float32"))


# ------------------------------------------------------------- on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
class TestSsdScanOnCard:
    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("shape", [(8, 512, 24, 64, 128),   # the prefill
                                       (2, 1000, 24, 64, 128),  # ragged
                                       (1, 4096, 24, 64, 128),  # segments
                                       (1, 4000, 24, 64, 128),  # mid-segment
                                       (1, 4096, 3, 32, 128),   # a t=16 rank
                                       (2, 200, 16, 32, 16),    # smoke widths
                                       (3, 1, 4, 32, 16)])      # one row
    def test_ssd_scan_matches_plain(self, cuda, shape, dtype):
        args = _inputs(*shape, dtype, device=cuda)
        before = LAUNCHES["ssd_scan"]
        got = ssd_scan(*args)
        torch.cuda.synchronize()
        assert LAUNCHES["ssd_scan"] == before + 1
        want = ssd_scan_ref(*args)
        tol = DTYPES[dtype][1]
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                       rtol=tol)

    def test_segments_split_the_long_prompts(self, cuda):
        """b=1 x 4,096 and the b=8 prefill walk several segments; 4,000
        rows end inside a segment and inside a chunk."""
        seg = {}
        for b, s in ((1, 4096), (1, 4000), (8, 512)):
            x = torch.empty((b, s, 24, 64), dtype=torch.bfloat16, device=cuda)
            seg[s] = segment_chunks(x) * chunk()
            assert s > seg[s], (b, s, seg[s])
        assert 4000 % seg[4000] != 0 and 4000 % chunk() != 0

    def test_dispatch_refuses_grad_on_cuda(self, cuda):
        """(Named for what it held before the SSD backward existed.)  With
        grad on, dispatch.ssd on CUDA tensors runs the autograd op of the
        two kernels: one launch of each, and the gradients of the plain
        version's autograd; the raw scan wrapper still refuses inputs that
        require grad; under no_grad the scan alone runs."""
        args = [t.requires_grad_(True) for t in
                _inputs(1, 200, 24, 64, 128, "float32", device=cuda)]
        before = dict(LAUNCHES)
        y, state = dispatch.ssd(*args)
        dy, ds = (torch.from_numpy(a).to(cuda) for a in _cotangents(
            y.shape, state.shape, True))
        got = torch.autograd.grad((y * dy).sum() + (state * ds).sum(), args)
        torch.cuda.synchronize()
        assert LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
        assert LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        with dispatch.force("ref"):
            yr, sr = dispatch.ssd(*leaves)
        want = torch.autograd.grad((yr * dy).sum() + (sr * ds).sum(), leaves)
        _assert_grads_close(got, want, DTYPES["float32"][1])
        with pytest.raises(NotImplementedError, match="the SSD backward"):
            ssd_scan(*args)
        with torch.no_grad():
            dispatch.ssd(*args)
        assert LAUNCHES["ssd_scan"] == before["ssd_scan"] + 2

    @pytest.mark.parametrize("with_state", [False, True])
    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("shape", [(1, 1024, 24, 64, 128),  # training
                                       (2, 1000, 24, 64, 128),  # ragged
                                       (4, 512, 24, 64, 128),   # b = 4
                                       (1, 1024, 256, 64, 128),  # jamba's 256
                                       (1, 100, 9, 64, 128),    # uneven groups
                                       (1, 4096, 3, 32, 128),   # a t=16 rank
                                       (2, 1000, 3, 32, 128),   # ragged rank
                                       (2, 200, 16, 32, 16),    # smoke widths
                                       (3, 1, 4, 32, 16)])      # one row
    def test_ssd_scan_bwd_matches_plain(self, cuda, shape, dtype, with_state):
        """Against ssd_scan_bwd_ref, max |d| <= tol * max |ref| per
        gradient at the SSD tolerances (2e-3 float32, 5e-2 bfloat16)."""
        args = _inputs(*shape, dtype, device=cuda)
        b, s, h, p, n = shape
        dy, ds = _cotangents((b, s, h, p), (b, h, p, n), with_state)
        dy = torch.from_numpy(dy).to(device=cuda, dtype=args[0].dtype)
        ds = None if ds is None else torch.from_numpy(ds).to(cuda)
        before = LAUNCHES["ssd_scan_bwd"]
        got = ssd_scan_bwd(*args, dy, ds)
        torch.cuda.synchronize()
        assert LAUNCHES["ssd_scan_bwd"] == before + 1
        want = ssd_scan_bwd_ref(*args, dy, ds)
        assert [g.dtype for g in got] == [w.dtype for w in want]
        assert all(bool(torch.isfinite(g.float()).all()) for g in got)
        _assert_grads_close([g.cpu() for g in got], [w.cpu() for w in want],
                            DTYPES[dtype][1])
        again = ssd_scan_bwd(*args, dy, ds)
        assert all(torch.equal(g, a) for g, a in zip(got, again))

    def test_ssd_scan_bwd_reruns_are_bit_identical(self, cuda):
        """No atomics: the heads' dB and dC are summed in a fixed order, in
        the cluster, so three runs at the training shape agree bit for
        bit."""
        b, s, h, p, n = 1, 1024, 24, 64, 128
        args = _inputs(b, s, h, p, n, "bfloat16", device=cuda)
        dy, ds = (torch.from_numpy(a).to(cuda) for a in _cotangents(
            (b, s, h, p), (b, h, p, n), True))
        runs = [ssd_scan_bwd(*args, dy.bfloat16(), ds) for _ in range(3)]
        for again in runs[1:]:
            assert all(torch.equal(g, a) for g, a in zip(runs[0], again))

    @pytest.mark.parametrize("dtype", list(DTYPES))
    @pytest.mark.parametrize("shape", [(3, 1, 4, 32, 16), (2, 1, 24, 64, 128)])
    def test_ssd_scan_bwd_one_row_gives_zero_dA_log(self, cuda, shape, dtype):
        """At one row the gradient of A_log is 0 in math: the decay of the
        only step acts on a zero state.  The kernel's cancelling products
        are rounded once each, so it comes out exactly 0, as the plain
        version's does."""
        b, s, h, p, n = shape
        args = _inputs(*shape, dtype, device=cuda)
        dy, ds = _cotangents((b, s, h, p), (b, h, p, n), True)
        dy = torch.from_numpy(dy).to(device=cuda, dtype=args[0].dtype)
        ds = torch.from_numpy(ds).to(cuda)
        got = ssd_scan_bwd(*args, dy, ds)
        assert bool((got[2] == 0).all()), got[2]
        assert bool((ssd_scan_bwd_ref(*args, dy, ds)[2] == 0).all())

    def test_dispatch_on_cuda_launches_the_kernel(self, cuda):
        args = _inputs(1, 64, 24, 64, 128, "bfloat16", device=cuda)
        before = LAUNCHES["ssd_scan"]
        y, state = dispatch.ssd(*args)
        assert LAUNCHES["ssd_scan"] == before + 1
        with dispatch.force("ref"):
            dispatch.ssd(*args)
        assert LAUNCHES["ssd_scan"] == before + 1
        assert y.dtype == torch.bfloat16 and state.dtype == torch.float32

    def test_ssd_scan_refuses_unsupported_widths(self, cuda):
        with pytest.raises(ValueError, match=r"\(16, 8\) not in"):
            ssd_scan(*_inputs(1, 8, 2, 16, 8, "float32", device=cuda))
        args = list(_inputs(1, 8, 2, 32, 16, "float32", device=cuda))
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            ssd_scan(*args)
