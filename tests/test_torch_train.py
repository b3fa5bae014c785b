"""The port's training path against the JAX package's, on the CPU: the Adam
update, the learning-rate schedule, the attention gradient, the loss, the
parameter count, remat, the synthetic data, the whole train step on the
smoke configs of gpt2-350m, llama3.2-3b, starcoder2-3b, deepseek-v2-236b,
mamba2-130m and jamba-1.5-large-398b, and the training driver.

Inputs are drawn with numpy from fixed seeds; JAX parameters are handed
over as numpy arrays through ``params_from_numpy``, in float32 on both
sides.  Tolerances and their reasons:

* Adam: atol 1e-6, rtol 1e-5, the JAX package's own kernel tolerance
  (tests/test_kernels.py::test_adam_fused_sweep).
* attention gradient in float32: 2e-5, the JAX package's float32 kernel
  tolerance; the two sides sum the same products in different orders.
* train step: loss and grad norm rel 1e-5; per-leaf grads max|d|/max|g|
  <= 1e-4; params atol 1e-6, rtol 1e-5.  The frameworks sum the same
  products in different orders through two layers and a softmax over the
  vocabulary (the observed gaps are a few 1e-7 relative).  Adam's first
  step maps each gradient to +-lr, so an element whose gradient is about 0
  and which the two sides round to opposite signs moves by 2 lr: the share
  of such elements is bounded (<= 1e-4 of each leaf) instead of loosening
  the tolerance for all.
* jamba's 16 sub-layers (8 of them MoE) amplify those few first-step
  flips: run free, its loss drifts from JAX's by 3.6e-5 relative at step 2
  and 2.2e-4 at step 3, while each step taken from JAX's state agrees
  within 3e-7.  So its three steps each start from JAX's state
  (``RESYNC_ARCHS``), and its parameters are held by
  ``test_train_step_params_of_the_hybrid_match_jax``: every element outside
  the Adam tolerance is one whose gradient is within rounding of 0.  Those
  resynced jamba steps and the training driver's tests live in
  tests/test_torch_train_jamba_and_driver.py, which imports this file's
  helpers: the test runner spreads whole files over its workers, and this
  file alone set the suite's wall.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_arch as jax_get_arch
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.kernels.adam_update import adam_ref as jax_adam_ref
from repro.kernels.adam_update import adam_update_fused as jax_adam_fused
from repro.launch.mesh import make_plan_mesh
from repro.models import cross_entropy as jax_cross_entropy
from repro.models import param_count as jax_param_count
from repro.models.attention import chunked_attention
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import lr_at as jax_lr_at
from repro.train import make_train_state as jax_make_train_state
from repro_torch.configs import TrainConfig, get_arch, smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import LAUNCHES, dispatch
from repro_torch.kernels.adam_update import adam_ref
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref)
from repro_torch.launch import ALLOC_CONF, configure_allocator
from repro_torch.launch import train as train_main
from repro_torch.models import cross_entropy, forward, init_params, param_count
from repro_torch.train import build_train_step, init_opt_state, lr_at
from repro_torch.train.optimizer import tree_leaves

ARCHS = ["gpt2-350m", "llama3.2-3b", "starcoder2-3b", "deepseek-v2-236b",
         "mamba2-130m"]
# archs whose port steps each start from the JAX step's state (see above)
RESYNC_ARCHS = ["jamba-1.5-large-398b"]
ADAM_TOL = dict(atol=1e-6, rtol=1e-5)
ADAM_KW = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1, c1=0.5,
               c2=0.2)
# the shapes of tests/test_kernels.py::test_adam_fused_sweep
ADAM_SHAPES = [((1000,), 256), ((64, 130), 1024), ((37,), 128),
               ((4096,), 512)]
# (b, sq, sk, H, K, D, causal, window)
ATTN_CASES = [
    (2, 64, 64, 4, 4, 32, True, 0),          # causal MHA
    (1, 96, 96, 4, 2, 32, True, 16),         # window, GQA G = 2
    (2, 48, 48, 6, 2, 64, True, 0),          # GQA G = 3
    (1, 40, 72, 4, 1, 32, False, 0),         # MQA, sq != sk, noncausal
]


def _np(x):
    """A float32 numpy copy: the port updates its state in place."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------------- Adam --

def _adam_inputs(shape, seed=2):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    m = rng.standard_normal(shape).astype(np.float32) * 0.1
    v = np.abs(rng.standard_normal(shape)).astype(np.float32) * 0.01
    mp = rng.standard_normal(shape).astype(np.float32)
    return g, m, v, mp


@pytest.mark.parametrize("shape,block", ADAM_SHAPES)
def test_adam_ref_matches_jax(shape, block):
    arrays = _adam_inputs(shape)
    got = adam_ref(*(torch.from_numpy(a) for a in arrays), **ADAM_KW)
    want_ref = jax_adam_ref(*(jnp.asarray(a) for a in arrays), **ADAM_KW)
    want_fused = jax_adam_fused(*(jnp.asarray(a) for a in arrays),
                                block=block, interpret=True, **ADAM_KW)
    for name, a, r, f in zip(["m", "v", "master", "param"], got, want_ref,
                             want_fused):
        assert tuple(a.shape) == shape
        np.testing.assert_allclose(_np(a), _np(r), err_msg=name, **ADAM_TOL)
        np.testing.assert_allclose(_np(a), _np(f), err_msg=name, **ADAM_TOL)
    assert got[3].dtype == torch.bfloat16


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_adam_update_leaf_on_cpu_updates_in_place(param_dtype):
    g, m, v, mp = (torch.from_numpy(a) for a in _adam_inputs((64, 130)))
    want = adam_ref(g, m, v, mp, **ADAM_KW)
    param = torch.zeros(mp.shape, dtype=param_dtype)
    ptrs = [t.data_ptr() for t in (m, v, mp, param)]
    before = dict(LAUNCHES)
    dispatch.adam_update_leaf(g, m, v, mp, param, **ADAM_KW)
    assert [t.data_ptr() for t in (m, v, mp, param)] == ptrs
    for got, w in zip((m, v, mp), want[:3]):
        assert torch.equal(got, w)
    assert torch.equal(param, want[2].to(param_dtype))
    assert LAUNCHES == before


def test_lr_at_matches_jax():
    tc = TrainConfig(warmup_steps=3, steps=12, learning_rate=3e-4)
    jtc = JaxTrainConfig(**dataclasses.asdict(tc))
    for step in range(16):
        want = float(jax_lr_at(jtc, jnp.asarray(step, jnp.int32)))
        assert lr_at(tc, step) == pytest.approx(want, rel=1e-6, abs=0)


def test_init_opt_state_never_aliases():
    params = {"a": torch.ones(3, 2), "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    opt = init_opt_state(params)
    for p, mp, m in zip(tree_leaves(params), tree_leaves(opt["master"]),
                        tree_leaves(opt["m"])):
        assert mp.dtype == torch.float32 and mp.data_ptr() != p.data_ptr()
        assert torch.equal(mp, p.float()) and not m.any()


# -------------------------------------------------------------- attention --

def _attn_case(case, seed=0):
    b, sq, sk, H, K, D, causal, window = case
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((b, sq, H, D), (b, sk, K, D), (b, sk, K, D), (b, sq, H, D))]
    return arrays, dict(causal=causal, window=window)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_grads_match_jax(case):
    """attention_bwd_ref (explicit formulas from o and lse) and autograd
    through attention_ref against jax.vjp of chunked_attention."""
    (q, k, v, do), kw = _attn_case(case)
    want = jax.jit(lambda a, b_, c, d: jax.vjp(
        lambda x, y, z: chunked_attention(x, y, z, **kw), a, b_, c)[1](d))(
            *(jnp.asarray(a) for a in (q, k, v, do)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = attention_ref(tq, tk, tv, **kw)
    explicit = attention_bwd_ref(tq, tk, tv, o, attention_lse_ref(tq, tk, **kw),
                                 tdo, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    attention_ref(*leaves, **kw).backward(tdo)
    for name, w, e, a in zip("qkv", want, explicit, leaves):
        np.testing.assert_allclose(_np(e), _np(w), atol=2e-5, rtol=2e-5,
                                   err_msg=f"d{name} explicit")
        np.testing.assert_allclose(_np(a.grad), _np(w), atol=2e-5, rtol=2e-5,
                                   err_msg=f"d{name} autograd")


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_lse_matches_jax(case):
    (q, k, _, _), kw = _attn_case(case, seed=1)
    b, sq, sk, H, K, D = case[:6]
    qr = jnp.asarray(q).reshape(b, sq, K, H // K, D)
    s = jnp.einsum("bqkgd,bskd->bkgqs", qr, jnp.asarray(k)) * D ** -0.5
    qp, kp = jnp.arange(sq)[:, None], jnp.arange(sk)[None, :]
    ok = jnp.ones((sq, sk), bool)
    if kw["causal"]:
        ok &= kp <= qp
    if kw["window"]:
        ok &= kp > qp - kw["window"]
    want = jax.nn.logsumexp(jnp.where(ok, s, -1e30), axis=-1).reshape(b, H, sq)
    got = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_fully_masked_row_gets_zero_grads():
    """A window with sq > sk + window leaves the last rows no key: their
    plain-version gradients are 0, never NaN."""
    (q, k, v, do), _ = _attn_case((1, 40, 8, 2, 2, 32, True, 4))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(causal=True, window=4)
    lse = attention_lse_ref(tq, tk, **kw)
    assert bool((lse[:, :, 12:] < -1e29).all())
    dq, dk, dv = attention_bwd_ref(tq, tk, tv, attention_ref(tq, tk, tv, **kw),
                                   lse, tdo, **kw)
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    assert not dq[:, 12:].any()


# ------------------------------------------------------- loss, count, data --

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = jax_cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16),
                             jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                        torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS + RESYNC_ARCHS)
def test_param_count_matches_jax(arch):
    assert param_count(get_arch(arch)) == jax_param_count(jax_get_arch(arch))
    if arch == "gpt2-350m":
        assert param_count(get_arch(arch)) == 353_503_232


def test_synthetic_tokens_match_jax():
    cfg, jcfg = smoke_config("gpt2-350m"), jax_smoke_config("gpt2-350m")
    ours, theirs = SyntheticTokens(cfg, 4, 64, seed=0), \
        JaxSyntheticTokens(jcfg, 4, 64, seed=0)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_remat_is_bit_identical():
    cfg = smoke_config("llama3.2-3b")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)))
    grads = []
    for remat in (False, True):
        params = init_params(cfg, 0, device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        logits, _ = forward(cfg, params, {"tokens": toks}, remat=remat)
        loss = cross_entropy(logits[:, :-1], toks[:, 1:])
        loss.backward()
        grads.append((loss.detach(), [p.grad for p in leaves]))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)


# ------------------------------------------------------------- train step --

def _jax_leaves(tree):
    return [np.array(a, np.float32) for a in jax.tree.leaves(tree)]


def _load_jax_state(state, jstate):
    """Copy the JAX step's params and Adam state into the port's, in
    place (the leaves are in the same order on both sides)."""
    for key, src in (("params", jstate["params"]),
                     *((k, jstate["opt"][k]) for k in ("m", "v", "master"))):
        dst = state["params"] if key == "params" else state["opt"][key]
        with torch.no_grad():
            for t, a in zip(tree_leaves(dst), jax.tree.leaves(src)):
                t.copy_(torch.from_numpy(np.array(a, np.float32)))


def _three_steps(arch, resync):
    """Three steps of the JAX step (jitted, one-device mesh) and of the
    port's step from the same fp32 params on the same batches; returns
    what each side had after each step.  With ``resync`` each port step
    starts from the JAX state of the step before."""
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    kw = dict(global_batch=4, seq_len=32, microbatch=2, steps=3,
              warmup_steps=1)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    jparams = jax.tree.map(
        lambda a: a.astype(jnp.float32),
        jax_make_train_state(jcfg, jtc, jax.random.PRNGKey(0))["params"])
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu", dtype=torch.float32)
    jstate = {"params": jparams, "opt": jax_init_opt_state(jparams),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": init_opt_state(params), "step": 0}
    jstep, jn = jax_build_train_step(jcfg, jtc, make_plan_mesh(1, 1), 4, 32,
                                     jit=True)
    step, n = build_train_step(cfg, tc, 4, 32)
    assert n == jn == 2
    data = SyntheticTokens(cfg, 4, 32, seed=0)
    out = []
    for i in range(3):
        raw = next(data)
        if i and resync:
            _load_jax_state(state, jstate)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in raw.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in raw.items()})
        out.append(dict(
            jax=dict(loss=float(jm["loss"]), gnorm=float(jm["grad_norm"]),
                     m=_jax_leaves(jstate["opt"]["m"]),
                     params=_jax_leaves(jstate["params"])),
            port=dict(loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
                      m=[_np(t) for t in tree_leaves(state["opt"]["m"])],
                      params=[_np(t) for t in tree_leaves(state["params"])])))
    assert state["step"] == 3 and int(jstate["step"]) == 3
    return out


@pytest.fixture(scope="module", params=ARCHS)
def three_steps(request):
    return _three_steps(request.param, resync=False)


def _assert_loss_and_grad_norm_match(steps):
    """The loss falls over the three steps on the port as it does on JAX
    (mamba2's, on new batches each step, does not on either side: 6.6143
    then 6.6162; the driver test below trains it for 12 steps)."""
    for rec in steps:
        for key in ("loss", "gnorm"):
            assert rec["port"][key] == pytest.approx(rec["jax"][key], rel=1e-5)
    assert ((steps[-1]["port"]["loss"] < steps[0]["port"]["loss"])
            == (steps[-1]["jax"]["loss"] < steps[0]["jax"]["loss"]))


def _assert_grads_match(steps):
    """After one step from m = 0, m = (1 - beta1) * grad on both sides."""
    rec = steps[0]
    for got, want in zip(rec["port"]["m"], rec["jax"]["m"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_train_step_loss_and_grad_norm_match_jax(three_steps):
    _assert_loss_and_grad_norm_match(three_steps)


def test_train_step_grads_match_jax(three_steps):
    _assert_grads_match(three_steps)


@pytest.mark.parametrize("after", [1, 3])
def test_train_step_params_match_jax(three_steps, after):
    rec = three_steps[after - 1]
    for got, want in zip(rec["port"]["params"], rec["jax"]["params"]):
        assert got.shape == want.shape
        off = np.abs(got - want) > ADAM_TOL["atol"] + ADAM_TOL["rtol"] * np.abs(want)
        assert off.mean() <= 1e-4, (off.sum(), off.size)
        assert np.abs(got - want).max() <= 2.5 * 3e-4 * after


def test_entry_points_set_the_allocator_unless_the_caller_did(monkeypatch):
    """Both drivers call configure_allocator before touching the card: it
    sets PYTORCH_CUDA_ALLOC_CONF to growable segments and keeps a value the
    caller set."""
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    configure_allocator()
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == ALLOC_CONF
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:False")
    configure_allocator()
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == "expandable_segments:False"
