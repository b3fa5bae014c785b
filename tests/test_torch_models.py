"""The port's model functions against the JAX package's, on the smoke
configs of llama3.2-3b, starcoder2-3b (sliding window 16, so ring caches
wrap), deepseek-v2-236b (MLA attention with a latent ring cache, a MoE
FFN on every layer), mamba2-130m (Mamba2 SSD layers with a conv window
and a float32 state for a cache) and jamba-1.5-large-398b (two blocks of
8 sub-layers: Mamba2 mixers with GQA at offset 4, MoE FFNs on the odd
sub-layers and dense SwiGLU on the even ones).

Parameters come from the JAX package's ``init_params``, cast to float32 on
both sides and handed over as numpy arrays through
``repro_torch.interop.params_from_numpy``.  The whole-model tolerance is
1e-4 absolute and relative in float32: the two frameworks sum the same
products in different orders through two layers (the observed gap is a few
1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.kernels import dispatch as jax_dispatch
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.transformer import cache_from_prefill as jax_cache_from_prefill
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import (cache_from_prefill, decode_step, forward,
                                init_cache, init_params, param_shapes)
from repro_torch.models.attention import apply_rope
from repro_torch.models.common import rms_norm


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's tests, restored after: the CPU
    ops here are small, and a pool of spinning threads per test process
    only crowds the other processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["llama3.2-3b", "starcoder2-3b", "deepseek-v2-236b", "mamba2-130m",
         "jamba-1.5-large-398b"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module", params=ARCHS)
def fp32_pair(request):
    """(jax cfg, jax params, port cfg, port params), float32 both sides."""
    arch = request.param
    jcfg = jax_smoke_config(arch)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jax_init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = smoke_config(arch)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu", dtype=torch.float32)
    return jcfg, jparams, cfg, params


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ----------------------------------------------------------- building blocks --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
                    ).astype(dtype)
    scale = jnp.asarray(rng.standard_normal(64).astype(np.float32)).astype(dtype)
    want = jax_common.rms_norm(x, scale, 1e-5)
    got = rms_norm(torch.tensor(_np(x)).to(getattr(torch, dtype)),
                   torch.tensor(_np(scale)).to(getattr(torch, dtype)), 1e-5)
    assert str(got.dtype).endswith(dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_jax(per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    pos = (np.array([[3], [40]]) + np.arange(6)[None] if per_row
           else np.arange(6) + 7)
    want = jax_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                               5e5)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_init_params_tree_matches_jax_shapes():
    for arch in ARCHS:
        want = jax.eval_shape(
            lambda k, a=arch: jax_init_params(jax_smoke_config(a), k),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
        got = init_params(smoke_config(arch), 0, device="cpu")
        flat_want = {jax.tree_util.keystr(p): (tuple(l.shape), str(l.dtype))
                     for p, l in jax.tree_util.tree_leaves_with_path(want)}
        flat_got = {jax.tree_util.keystr(p): (tuple(l.shape),
                                              str(l.dtype).split(".")[-1])
                    for p, l in jax.tree_util.tree_leaves_with_path(got)}
        assert flat_got == flat_want


def test_jamba_smoke_tree_has_the_jax_sub_layers():
    """jamba's blocks hold one sub-layer a position of the 8-layer period,
    each of its layer's kind (the leaves and shapes are the JAX tree's, by
    the test above): GQA at sub4 and Mamba2 elsewhere, MoE FFNs at the odd
    sub-layers and dense SwiGLU at the even ones."""
    blocks = param_shapes(smoke_config("jamba-1.5-large-398b"))["blocks"]
    assert sorted(blocks) == [f"sub{j}" for j in range(8)]
    for j in range(8):
        assert ("wq" if j == 4 else "A_log") in blocks[f"sub{j}"]["mixer"]
        assert ("router" if j % 2 else "w1") in blocks[f"sub{j}"]["ffn"]


def test_init_params_is_seeded():
    cfg = smoke_config("llama3.2-3b")
    a = init_params(cfg, 3, device="cpu")
    b = init_params(cfg, 3, device="cpu")
    c = init_params(cfg, 4, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    wo = a["blocks"]["sub0"]["mixer"]["wo"].float()
    # fan-in of wo (H, hd, d) is H, as in the JAX package's dense_init
    expect = (1 / np.sqrt(2 * cfg.num_layers)) / np.sqrt(cfg.num_heads)
    # a standard normal truncated at +-3 has std 0.9866
    assert abs(wo.std().item() / expect - 0.9866) < 0.02


def test_init_params_follows_the_jax_recipe_for_mla_and_moe():
    """deepseek-v2's smoke config: the MLA norms q_ln/kv_ln at 1, the
    router float32 with fan-in d, the stacked experts (nb, E, d, f) with
    fan-in on axis 2, and 1/sqrt(2L) on w2 and shared_w2 (moe.py:37-49 and
    attention.py:320-335 of the JAX package)."""
    cfg = smoke_config("deepseek-v2-236b")
    sub = init_params(cfg, 5, device="cpu")["blocks"]["sub0"]
    for name in ("q_ln", "kv_ln"):
        leaf = sub["mixer"][name]
        assert leaf.dtype == torch.bfloat16 and torch.all(leaf == 1)
    ffn = sub["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for k, t in ffn.items()
               if k != "router")
    out = 1 / np.sqrt(2 * cfg.num_layers)
    d, f = cfg.d_model, cfg.moe_d_ff
    fs = cfg.num_shared_experts * f
    # (leaf, expected std before truncation, tolerance on the ratio from the
    # sample size: the router has 2,048 entries, the others >= 65,536)
    for leaf, std, tol in ((ffn["router"], 1 / np.sqrt(d), 0.05),
                           (ffn["w1"], 1 / np.sqrt(d), 0.02),
                           (ffn["w3"], 1 / np.sqrt(d), 0.02),
                           (ffn["w2"], out / np.sqrt(f), 0.02),
                           (ffn["shared_w1"], 1 / np.sqrt(d), 0.02),
                           (ffn["shared_w2"], out / np.sqrt(fs), 0.02),
                           (sub["mixer"]["wk_b"],
                            1 / np.sqrt(cfg.kv_lora_rank), 0.02)):
        # a standard normal truncated at +-3 has std 0.9866
        assert abs(leaf.float().std().item() / std - 0.9866) < tol


def test_init_params_follows_the_jax_recipe_for_jamba_ffns():
    """jamba's smoke config: the dense SwiGLU of the even sub-layers, (nb, d,
    f) stacked, takes its fan-in per layer (axis 1: the JAX package's
    ``_init_mlp``), the experts of the odd ones, (nb, E, d, f), per expert
    (axis 2); 1/sqrt(2L) on both w2 (transformer.py:33-41 and moe.py:37-49
    of the JAX package)."""
    cfg = smoke_config("jamba-1.5-large-398b")
    blocks = init_params(cfg, 6, device="cpu")["blocks"]
    assert sorted(blocks) == [f"sub{j}" for j in range(8)]
    out = 1 / np.sqrt(2 * cfg.num_layers)
    d, f, fe = cfg.d_model, cfg.d_ff, cfg.moe_d_ff
    dense, moe = blocks["sub0"]["ffn"], blocks["sub1"]["ffn"]
    assert tuple(dense["w1"].shape) == (2, d, f) and "router" not in dense
    assert tuple(moe["w1"].shape) == (2, cfg.num_experts, d, fe)
    assert moe["router"].dtype == torch.float32
    assert "ffn" in blocks["sub4"] and "wq" in blocks["sub4"]["mixer"]
    # (leaf, expected std before truncation): a dense w2 is (f, d) per
    # layer, fan-in f; on axis 2 it would be d
    for leaf, std in ((dense["w1"], 1 / np.sqrt(d)),
                      (dense["w3"], 1 / np.sqrt(d)),
                      (dense["w2"], out / np.sqrt(f)),
                      (moe["w1"], 1 / np.sqrt(d)),
                      (moe["w2"], out / np.sqrt(fe))):
        # a standard normal truncated at +-3 has std 0.9866
        assert abs(leaf.float().std().item() / std - 0.9866) < 0.02


def test_params_from_numpy_keeps_the_router_float32():
    """A float32 tree of deepseek-v2's smoke shapes: every leaf is cast to
    bf16 but the router, which keeps its float32 values bit for bit."""
    cfg = smoke_config("deepseek-v2-236b")
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda shape: rng.standard_normal(shape).astype(
        np.float32), param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    params = params_from_numpy(cfg, tree, device="cpu")
    ffn = params["blocks"]["sub0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert np.array_equal(ffn["router"].numpy(),
                          tree["blocks"]["sub0"]["ffn"]["router"])
    assert ffn["w1"].dtype == torch.bfloat16


def test_params_from_numpy_keeps_the_ssm_vectors_float32():
    """mamba2-130m's smoke shapes: A_log, D and dt_bias are float32 in the
    JAX package (mamba2.py:38-40) and keep their values bit for bit; the
    matrices and the gated norm are cast to bf16."""
    cfg = smoke_config("mamba2-130m")
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda shape: rng.standard_normal(shape).astype(
        np.float32), param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    mixer = params_from_numpy(cfg, tree, device="cpu")["blocks"]["sub0"]["mixer"]
    for name in ("A_log", "D", "dt_bias"):
        assert mixer[name].dtype == torch.float32
        assert np.array_equal(mixer[name].numpy(),
                              tree["blocks"]["sub0"]["mixer"][name])
    assert mixer["in_zx"].dtype == mixer["norm"].dtype == torch.bfloat16


def test_params_from_numpy_rejects_a_wrong_tree():
    cfg = smoke_config("llama3.2-3b")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax_init_params(
        jax_smoke_config("llama3.2-3b"), jax.random.PRNGKey(0)))
    tree["final_norm"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(cfg, tree, device="cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(cfg, tree, device="cpu")


# ------------------------------------------------------------ whole model --

def test_forward_matches_jax(fp32_pair):
    jcfg, jparams, cfg, params = fp32_pair
    toks = _tokens(cfg, 2, 12)
    jl, _, jc = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                            want_cache=True)
    tl, tc = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                     want_cache=True)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert set(tc) == set(jc)
    for sub in jc:
        assert set(tc[sub]) == set(jc[sub])
        for name in jc[sub]:
            np.testing.assert_allclose(_np(tc[sub][name]),
                                       _np(jc[sub][name]), **TOL)
    last, _ = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                      last_only=True)
    np.testing.assert_allclose(_np(last), _np(tl[:, -1:]), **TOL)


def test_forward_aux_matches_jax(fp32_pair):
    """The MoE load-balance loss summed over the layers, the JAX forward's
    second value: deepseek-v2's smoke config routes every layer through a
    MoE FFN, jamba's every other layer (sub-layers 1, 3, 5, 7 of each
    block); the other archs have none, and both sides give 0.  Held at the
    MoE tests' 1e-5 (tests/test_torch_moe.py)."""
    jcfg, jparams, cfg, params = fp32_pair
    toks = _tokens(cfg, 2, 12, seed=5)
    _, jaux, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    for remat in (False, True):
        _, cache, aux = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                                remat=remat, want_aux=True)
        assert cache is None and aux.dtype == torch.float32 and aux.ndim == 0
        assert aux.item() == pytest.approx(float(jaux), rel=1e-5, abs=1e-5)
    assert (float(jaux) > 0) == any(cfg.layer_is_moe(l)
                                    for l in range(cfg.num_layers))


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_matches_jax(fp32_pair, per_row):
    """Prefill 12 tokens into a 24-token cache (a 16-slot ring for
    starcoder2), then 8 decode steps: starcoder2's ring wraps at 16."""
    jcfg, jparams, cfg, params = fp32_pair
    toks = _tokens(cfg, 2, 12, seed=1)
    _, _, jc = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           want_cache=True)
    jcache = jax_cache_from_prefill(jcfg, jc, 24)
    _, tc = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                    want_cache=True)
    tcache = cache_from_prefill(cfg, tc, 24)
    new = _tokens(cfg, 2, 8, seed=2)
    offset = np.array([0, 3]) if per_row else 0      # rows apart by 3
    for i in range(8):
        pos = 12 + i + offset
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = torch.from_numpy(pos) if per_row else int(pos)
        jl, jcache = jax_decode_step(jcfg, jparams,
                                     jnp.asarray(new[:, i:i + 1]), jcache, jpos)
        tl, tcache = decode_step(cfg, params, torch.from_numpy(new[:, i:i + 1]),
                                 tcache, tpos)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for sub in jcache:
        for name in jcache[sub]:
            np.testing.assert_allclose(_np(tcache[sub][name]),
                                       _np(jcache[sub][name]), **TOL)


def test_ring_holds_a_prompt_longer_than_the_window():
    """A 20-token prompt into starcoder2's 16-slot ring: decoding the next
    token gives the logits of a full forward over the 21 tokens.  (The
    JAX package's cache_from_prefill keeps the last 16 positions at slots
    0..15, which agrees only when the prompt length is a multiple of 16.)"""
    cfg = smoke_config("starcoder2-3b")
    params = jax.tree.map(lambda t: t.float(), init_params(cfg, 0, device="cpu"))
    toks = torch.from_numpy(_tokens(cfg, 2, 21, seed=3))
    _, tc = forward(cfg, params, {"tokens": toks[:, :20]}, want_cache=True)
    cache = cache_from_prefill(cfg, tc, 24)
    assert cache["sub0"]["k"].shape[2] == cfg.sliding_window
    got, _ = decode_step(cfg, params, toks[:, 20:], cache, 20)
    want, _ = forward(cfg, params, {"tokens": toks}, last_only=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_cache_from_prefill_does_not_alias(fp32_pair):
    _, _, cfg, params = fp32_pair
    toks = torch.from_numpy(_tokens(cfg, 1, 16))
    _, tc = forward(cfg, params, {"tokens": toks}, want_cache=True)
    ring = cache_from_prefill(cfg, tc, 16)
    name = next(iter(tc["sub0"]))                  # k, or MLA's c_kv
    assert ring["sub0"][name].data_ptr() != tc["sub0"][name].data_ptr()
    before = tc["sub0"][name].clone()
    decode_step(cfg, params, toks[:, :1], ring, 16)
    assert torch.equal(tc["sub0"][name], before)


def test_mamba2_cache_has_no_sequence_axis():
    """init_cache gives Mamba2 a conv window of w - 1 rows in the cache
    dtype and an always-float32 state, whatever the cache length; a hybrid
    config holds one cache kind per sub-layer, and a modal prefix adds no
    parameters."""
    cfg = smoke_config("mamba2-130m")
    cache = init_cache(cfg, 3, 1000, dtype=torch.bfloat16, device="cpu")["sub0"]
    ch = cfg.d_inner + 2 * cfg.ssm_state
    assert tuple(cache["conv"].shape) == (2, 3, cfg.ssm_conv - 1, ch)
    assert cache["conv"].dtype == torch.bfloat16
    assert tuple(cache["ssd"].shape) == (2, 3, cfg.n_ssm_heads,
                                         cfg.ssm_head_dim, cfg.ssm_state)
    assert cache["ssd"].dtype == torch.float32
    hybrid = cfg.scaled(family="hybrid", attention="gqa", num_heads=8,
                        num_kv_heads=4, attn_layer_period=2, num_layers=2)
    both = init_cache(hybrid, 3, 20, dtype=torch.bfloat16, device="cpu")
    assert sorted(both["sub0"]) == ["k", "v"]
    assert sorted(both["sub1"]) == ["conv", "ssd"]
    assert tuple(both["sub0"]["k"].shape) == (1, 3, 20, 4, 32)
    assert param_shapes(cfg.scaled(num_modal_tokens=8)) == param_shapes(cfg)


def test_mamba2_forward_at_a_ragged_prompt_matches_the_pallas_path():
    """The whole mamba2 smoke model at prompt 200, which the JAX package's
    CPU path refuses (200 % 128 != 0): held against the JAX forward with
    its SSD op forced to the Pallas kernel in interpret mode, and prefill
    of 200 + one decode step against the forward over 201 tokens."""
    jcfg = jax_smoke_config("mamba2-130m")
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jax_init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = smoke_config("mamba2-130m")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu", dtype=torch.float32)
    toks = _tokens(cfg, 1, 201, seed=4)
    with jax_dispatch.force("pallas"):
        jl, _, jc = jax_forward(jcfg, jparams,
                                {"tokens": jnp.asarray(toks[:, :200])},
                                want_cache=True)
    tl, tc = forward(cfg, params, {"tokens": torch.from_numpy(toks[:, :200])},
                     want_cache=True)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for name in jc["sub0"]:
        np.testing.assert_allclose(_np(tc["sub0"][name]),
                                   _np(jc["sub0"][name]), **TOL)
    step, _ = decode_step(cfg, params, torch.from_numpy(toks[:, 200:]),
                          cache_from_prefill(cfg, tc, 201), 200)
    full, _ = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                      last_only=True)
    np.testing.assert_allclose(_np(step), _np(full), **TOL)
