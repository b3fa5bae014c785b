"""The six configurations the port gained last -- stablelm-12b (head dim
160 at full width), llava-next-34b (a VLM backbone that takes a prefix of
precomputed modal embeddings), musicgen-medium (MHA with GELU over EnCodec
tokens), mixtral-8x22b (MoE top-2 with a sliding window), starcoder2-7b
(GQA with a sliding window) and gpt2-7b (MHA with tied embeddings) --
held against the JAX package on their smoke configs, and every one of the
twelve held to the JAX package's own arch smoke checks on the port alone.

Against JAX, in float32 (parameters from the JAX package's ``init_params``
through ``params_from_numpy``): the forward's logits and cache entries,
prefill + decode steps (logits, and the cache's structure and values), and
greedy tokens.  llava-next's modal embeddings are drawn with numpy; its
greedy decoding and serve engine prefill zero embeddings, as the JAX
engine does.  The tolerance is tests/test_torch_models.py's, 1e-4 absolute
and relative: the two frameworks sum the same products in different
orders through two layers.

On the port alone, for all twelve archs (tests/test_arch_smoke.py's
checks): the smoke config's size, the forward's and one decode step's
output shapes with no NaN, and the decode cache's structure unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.transformer import cache_from_prefill as jax_cache_from_prefill
from repro.serve import greedy_decode as jax_greedy_decode
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import (cache_from_prefill, decode_step, forward,
                                init_cache, init_params)
from repro_torch.serve import (ContinuousBatcher, DisaggregatedBatcher,
                               ServeRequest, greedy_decode, prefill,
                               prompt_batch)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's tests, restored after: the CPU
    ops here are small, and a pool of spinning threads per test process
    only crowds the other processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NEW_ARCHS = ["stablelm-12b", "llava-next-34b", "musicgen-medium",
             "mixtral-8x22b", "starcoder2-7b", "gpt2-7b"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module", params=NEW_ARCHS)
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


def _batch(cfg, b, s_text, seed=0):
    """numpy tokens (b, s_text) and, for a VLM config, modal embeddings
    (b, num_modal_tokens, d) at the data pipeline's scale."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s_text)
                                    ).astype(np.int32)}
    if cfg.num_modal_tokens:
        batch["modal_embeds"] = (rng.standard_normal(
            (b, cfg.num_modal_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_smoke_configs_take_the_jax_shapes(fp32_pair):
    """The six configs' smoke variants are what the JAX package tests: the
    modal prefix of 8 for llava-next, the window of 16 for mixtral and
    starcoder2-7b, MHA kept MHA for musicgen and gpt2-7b."""
    jcfg, _, cfg, _ = fp32_pair
    assert cfg.num_modal_tokens == jcfg.num_modal_tokens
    assert (cfg.num_modal_tokens == 8) == (cfg.name == "llava-next-34b-smoke")
    assert cfg.sliding_window == jcfg.sliding_window
    if cfg.name in ("musicgen-medium-smoke", "gpt2-7b-smoke"):
        assert cfg.num_kv_heads == cfg.num_heads == 8


def test_forward_matches_jax(fp32_pair):
    jcfg, jparams, cfg, params = fp32_pair
    jb, tb = _both(_batch(cfg, 2, 12))
    jl, _, jc = jax_forward(jcfg, jparams, jb, want_cache=True)
    tl, tc = forward(cfg, params, tb, want_cache=True)
    assert tuple(tl.shape) == (2, 12 + cfg.num_modal_tokens, cfg.vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert set(tc) == set(jc)
    for sub in jc:
        assert set(tc[sub]) == set(jc[sub])
        for name in jc[sub]:
            np.testing.assert_allclose(_np(tc[sub][name]),
                                       _np(jc[sub][name]), **TOL)
    last, _ = forward(cfg, params, tb, last_only=True)
    np.testing.assert_allclose(_np(last), _np(tl[:, -1:]), **TOL)


def test_decode_steps_match_jax(fp32_pair):
    """Prefill 12 tokens (after llava's 8 modal embeddings) into a cache of
    24 + the prefix, then 5 decode steps at positions after the prefix:
    the windowed archs' 16-slot rings wrap at position 16.  The cache keeps
    its structure and matches JAX's."""
    jcfg, jparams, cfg, params = fp32_pair
    m = cfg.num_modal_tokens
    jb, tb = _both(_batch(cfg, 2, 12, seed=1))
    _, _, jc = jax_forward(jcfg, jparams, jb, want_cache=True)
    jcache = jax_cache_from_prefill(jcfg, jc, 24 + m)
    _, tc = forward(cfg, params, tb, want_cache=True)
    tcache = cache_from_prefill(cfg, tc, 24 + m)
    structure = {sub: {k: tuple(t.shape) for k, t in c.items()}
                 for sub, c in tcache.items()}
    new = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 5)
                                            ).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, pos: jax_decode_step(jcfg, p, t, c, pos))
    for i in range(5):
        pos = 12 + m + i
        jl, jcache = jstep(jparams, jnp.asarray(new[:, i:i + 1]), jcache,
                           jnp.int32(pos))
        tl, tcache = decode_step(cfg, params, torch.from_numpy(new[:, i:i + 1]),
                                 tcache, pos)
        assert tuple(tl.shape) == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert {sub: {k: tuple(t.shape) for k, t in c.items()}
            for sub, c in tcache.items()} == structure
    for sub in jcache:
        assert set(tcache[sub]) == set(jcache[sub])
        for name in jcache[sub]:
            np.testing.assert_allclose(_np(tcache[sub][name]),
                                       _np(jcache[sub][name]), **TOL)


def test_greedy_matches_jax(fp32_pair):
    """One prompt of 12 into a cache of 24 + the prefix, 6 new tokens, one
    request per call on both sides (see tests/test_torch_serve.py)."""
    jcfg, jparams, cfg, params = fp32_pair
    prompt = _batch(cfg, 1, 12, seed=3)["tokens"]
    cache_len = 24 + cfg.num_modal_tokens
    want = jax_greedy_decode(jcfg, jparams, jnp.asarray(prompt), 6, cache_len)
    got = greedy_decode(cfg, params, torch.from_numpy(prompt), 6, cache_len)
    assert got.tolist() == np.asarray(want).tolist()


# ------------------------------------------------------ llava's prefix --

@pytest.fixture(scope="module")
def llava_bf16():
    cfg = smoke_config("llava-next-34b")
    return cfg, init_params(cfg, 0, device="cpu")


def test_llava_prefill_puts_the_prefix_first(llava_bf16):
    """The serve engine's prefill batch carries zero modal embeddings of
    the embeddings' dtype; the cache holds prefix + prompt positions, and
    the forward differs when the prefix does."""
    cfg, params = llava_bf16
    prompt = torch.from_numpy(_batch(cfg, 2, 6, seed=4)["tokens"])
    batch = prompt_batch(cfg, params, prompt)
    assert tuple(batch["modal_embeds"].shape) == (2, 8, cfg.d_model)
    assert batch["modal_embeds"].dtype == params["embed"].dtype
    assert not batch["modal_embeds"].any()
    logits, cache = prefill(cfg, params, batch, 20)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    k = cache["sub0"]["k"]
    assert k.shape[2] == 20 and bool(k[:, :, :14].any())
    assert not k[:, :, 14:].any()
    other = dict(batch, modal_embeds=torch.full_like(batch["modal_embeds"], 0.5))
    assert not torch.equal(prefill(cfg, params, other, 20)[0], logits)


@pytest.mark.parametrize("batcher", [ContinuousBatcher, DisaggregatedBatcher])
def test_llava_batcher_matches_greedy(llava_bf16, batcher):
    """bfloat16 (batch-invariant on the CPU): 3 requests with unequal
    budgets through 2 slots, each row decoding from its prompt length plus
    the prefix; a request that fits without the prefix but not with it is
    refused."""
    cfg, params = llava_bf16
    prompts = torch.from_numpy(_batch(cfg, 3, 6, seed=5)["tokens"])
    gens = [5, 2, 4]
    cache_len = 6 + 8 + 5
    want = {i: greedy_decode(cfg, params, prompts[i:i + 1], gens[i],
                             cache_len)[0].tolist() for i in range(3)}
    cb = batcher(cfg, params, slots=2, cache_len=cache_len)
    for i in range(3):
        cb.submit(ServeRequest(i, prompts[i], gens[i]))
    assert cb.run() == want
    with pytest.raises(ValueError, match="8 modal"):
        cb.submit(ServeRequest(9, prompts[0], cache_len - 6))


# --------------------------------------------- all twelve, port alone --

def _port_batch(cfg, b, s, seed):
    """tests/test_arch_smoke.py's batch: s positions in all, the modal
    prefix at 0.01 before s - m text tokens."""
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (b, s - cfg.num_modal_tokens),
                                     generator=gen)}
    if cfg.num_modal_tokens:
        batch["modal_embeds"] = torch.full(
            (b, cfg.num_modal_tokens, cfg.d_model), 0.01, dtype=torch.bfloat16)
    return batch


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_forward_and_decode(arch):
    cfg = smoke_config(arch)
    assert cfg.d_model <= 512 and cfg.num_layers <= 16
    assert (cfg.num_experts or 0) <= 4
    params = init_params(cfg, 0, device="cpu")
    b, s = 2, 64
    batch = _port_batch(cfg, b, s, seed=0)
    logits, _ = forward(cfg, params, batch)
    assert tuple(logits.shape) == (b, s, cfg.vocab_size)
    assert not bool(torch.isnan(logits.float()).any())
    cache = init_cache(cfg, b, 32, device="cpu")
    structure = {sub: {k: (tuple(t.shape), t.dtype) for k, t in c.items()}
                 for sub, c in cache.items()}
    lg, new_cache = decode_step(cfg, params, batch["tokens"][:, :1], cache, 3)
    assert tuple(lg.shape) == (b, 1, cfg.vocab_size)
    assert not bool(torch.isnan(lg.float()).any())
    assert {sub: {k: (tuple(t.shape), t.dtype) for k, t in c.items()}
            for sub, c in new_cache.items()} == structure
