"""The port's serving engine: greedy tokens against the JAX package's
``greedy_decode``, the batchers against the port's own per-request greedy
decoding, request admission checks and the serve driver, all on the CPU.

The greedy comparison with JAX runs in float32, one request per call on
both sides: float32 products on this CPU give a row different bits at
batch 1 and batch > 1, so co-batching would move the tokens.  The batcher
comparisons run in bfloat16, whose CPU products are batch-invariant, as
the JAX package's own batcher tests do (tests/test_serve_plane.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.serve import greedy_decode as jax_greedy_decode
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_main
from repro_torch.models import init_params
from repro_torch.serve import (ContinuousBatcher, DisaggregatedBatcher,
                               ServeRequest, greedy_decode)


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
BATCHERS = [ContinuousBatcher, DisaggregatedBatcher]


def _prompts(cfg, n, s, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, s)))


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_greedy_matches_jax(arch):
    """Prompt 12 into a 24-token cache, 10 new tokens: starcoder2's
    16-slot ring wraps during decode."""
    jcfg = jax_smoke_config(arch)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jax_init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = smoke_config(arch)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu", dtype=torch.float32)
    prompts = _prompts(cfg, 2, 12, seed=7)
    for i in range(prompts.shape[0]):
        want = jax_greedy_decode(jcfg, jparams,
                                 jnp.asarray(prompts[i:i + 1].numpy(),
                                             jnp.int32), 10, 24)
        got = greedy_decode(cfg, params, prompts[i:i + 1], 10, 24)
        assert got.tolist() == np.asarray(want).tolist()


@pytest.fixture(scope="module")
def llama_bf16():
    cfg = smoke_config("llama3.2-3b")
    return cfg, init_params(cfg, 0, device="cpu")


def _greedy_each(cfg, params, prompts, gens, cache_len):
    return {i: greedy_decode(cfg, params, prompts[i:i + 1], gens[i],
                             cache_len)[0].tolist()
            for i in range(prompts.shape[0])}


@pytest.mark.parametrize("batcher", BATCHERS)
def test_batcher_matches_greedy(llama_bf16, batcher):
    """4 requests through 2 slots: admissions land mid-decode of other rows
    and every slot is reused."""
    cfg, params = llama_bf16
    prompts = _prompts(cfg, 4, 8, seed=3)
    want = _greedy_each(cfg, params, prompts, [5] * 4, 16)
    cb = batcher(cfg, params, slots=2, cache_len=16)
    for i in range(4):
        cb.submit(ServeRequest(i, prompts[i], 5))
    assert cb.run() == want
    assert cb.prefills == 4
    assert cb.decode_steps >= 8


@pytest.mark.parametrize("batcher", BATCHERS)
def test_batcher_staggered_and_unequal(llama_bf16, batcher):
    """Requests submitted while the batch is mid-flight, with unequal token
    budgets (slots free at different steps)."""
    cfg, params = llama_bf16
    prompts = _prompts(cfg, 3, 8, seed=5)
    gens = [5, 2, 4]
    want = _greedy_each(cfg, params, prompts, gens, 16)
    cb = batcher(cfg, params, slots=2, cache_len=16)
    cb.submit(ServeRequest(0, prompts[0], gens[0]))
    cb.step()
    cb.submit(ServeRequest(1, prompts[1], gens[1]))
    cb.step()
    cb.submit(ServeRequest(2, prompts[2], gens[2]))
    assert cb.run() == want


def test_disaggregated_splices_every_row(llama_bf16):
    cfg, params = llama_bf16
    prompts = _prompts(cfg, 3, 8, seed=9)
    cb = DisaggregatedBatcher(cfg, params, slots=2, cache_len=16)
    for i in range(3):
        cb.submit(ServeRequest(i, prompts[i], 3))
    out = cb.run()
    assert sorted(out) == [0, 1, 2] and cb.handoffs == 3 and cb.prefills == 3


@pytest.mark.parametrize("batcher", BATCHERS)
def test_oversized_prompt_is_rejected(llama_bf16, batcher):
    cfg, params = llama_bf16
    cb = batcher(cfg, params, slots=2, cache_len=16)
    with pytest.raises(ValueError, match="cannot fit"):
        cb.submit(ServeRequest(0, _prompts(cfg, 1, 12, seed=0)[0], 5))
    assert not cb.pending


@pytest.fixture(scope="module")
def deepseek_bf16():
    cfg = smoke_config("deepseek-v2-236b")
    return cfg, init_params(cfg, 0, device="cpu")


@pytest.mark.parametrize("batcher", BATCHERS)
def test_deepseek_batcher_matches_greedy(deepseek_bf16, batcher):
    """MLA latent rings and a MoE FFN through the batchers: 4 requests with
    unequal budgets through 2 slots, the last submitted mid-flight.  The
    MoE dispatch is row-local, so a row's tokens do not depend on its
    neighbours (idle slots included)."""
    cfg, params = deepseek_bf16
    prompts = _prompts(cfg, 4, 8, seed=11)
    gens = [5, 3, 4, 2]
    want = _greedy_each(cfg, params, prompts, gens, 16)
    cb = batcher(cfg, params, slots=2, cache_len=16)
    for i in range(3):
        cb.submit(ServeRequest(i, prompts[i], gens[i]))
    cb.step()
    cb.submit(ServeRequest(3, prompts[3], gens[3]))
    assert cb.run() == want
    assert set(cb.cache["sub0"]) == {"c_kv", "k_rope"}


@pytest.fixture(scope="module")
def mamba2_bf16():
    cfg = smoke_config("mamba2-130m")
    return cfg, init_params(cfg, 0, device="cpu")


@pytest.mark.parametrize("batcher", BATCHERS)
def test_mamba2_batcher_matches_greedy(mamba2_bf16, batcher):
    """Mamba2's conv windows and float32 states through the batchers: 4
    requests with unequal budgets and prompt lengths 1, 2, 8 and 8 (the
    first two shorter than the conv window) through 2 slots, the last
    submitted mid-flight.  A slot's state is overwritten whole at each
    admission, so what an earlier tenant left there cannot leak."""
    cfg, params = mamba2_bf16
    prompts = _prompts(cfg, 4, 8, seed=13)
    lengths, gens = [1, 2, 8, 8], [5, 3, 4, 2]
    want = {i: greedy_decode(cfg, params, prompts[i:i + 1, :lengths[i]],
                             gens[i], 16)[0].tolist() for i in range(4)}
    cb = batcher(cfg, params, slots=2, cache_len=16)
    for i in range(3):
        cb.submit(ServeRequest(i, prompts[i, :lengths[i]], gens[i]))
    cb.step()
    cb.submit(ServeRequest(3, prompts[3, :lengths[3]], gens[3]))
    assert cb.run() == want
    assert set(cb.cache["sub0"]) == {"conv", "ssd"}


def test_mamba2_splice_copies_the_state_exactly(mamba2_bf16):
    """A prefilled row spliced into a bf16 batcher's cache: the conv window
    keeps its bf16 bits and the SSD state its float32 bits (the ssd leaf
    is float32 whatever the cache dtype)."""
    cfg, params = mamba2_bf16
    cb = ContinuousBatcher(cfg, params, slots=3, cache_len=16)
    req = ServeRequest(0, _prompts(cfg, 1, 7, seed=17)[0], 4)
    with torch.inference_mode():                 # as step() runs it
        tok, row = cb._prefill_one(req)
        cb._splice(1, req, tok, row)
    for name in ("conv", "ssd"):
        got, want = cb.cache["sub0"][name][:, 1], row["sub0"][name][:, 0]
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    assert cb.cache["sub0"]["ssd"].dtype == torch.float32
    assert bool((cb.cache["sub0"]["ssd"][:, 1] != 0).any())


@pytest.fixture(scope="module")
def jamba_bf16():
    cfg = smoke_config("jamba-1.5-large-398b")
    return cfg, init_params(cfg, 0, device="cpu")


@pytest.mark.parametrize("batcher", BATCHERS)
def test_jamba_batcher_matches_greedy(jamba_bf16, batcher):
    """The hybrid's mixed caches through the batchers: per block, seven
    Mamba2 conv windows and float32 states and one GQA ring (sub4), every
    one spliced at admission.  4 requests with unequal budgets and prompt
    lengths 2, 5, 8 and 8 through 2 slots, the last submitted mid-flight."""
    cfg, params = jamba_bf16
    prompts = _prompts(cfg, 4, 8, seed=19)
    lengths, gens = [2, 5, 8, 8], [5, 3, 4, 2]
    want = {i: greedy_decode(cfg, params, prompts[i:i + 1, :lengths[i]],
                             gens[i], 16)[0].tolist() for i in range(4)}
    cb = batcher(cfg, params, slots=2, cache_len=16)
    for i in range(3):
        cb.submit(ServeRequest(i, prompts[i, :lengths[i]], gens[i]))
    cb.step()
    cb.submit(ServeRequest(3, prompts[3, :lengths[3]], gens[3]))
    assert cb.run() == want
    assert set(cb.cache["sub4"]) == {"k", "v"}
    assert all(set(cb.cache[f"sub{j}"]) == {"conv", "ssd"}
               for j in (0, 1, 2, 3, 5, 6, 7))


@pytest.mark.parametrize("extra", [[], ["--continuous", "3"],
                                   ["--continuous", "3", "--disaggregated"]])
def test_serve_driver_runs_on_cpu(extra, capsys):
    out = serve_main.main(["--arch", "llama3.2-3b", "--smoke", "--device",
                           "cpu", "--batch", "2", "--prompt-len", "8",
                           "--gen", "4", *extra])
    printed = capsys.readouterr().out
    assert "device=cpu" in printed and "tok/s" in printed
    if extra:
        assert sorted(out) == [0, 1, 2]
        assert all(len(t) == 4 for t in out.values())
    else:
        assert tuple(out.shape) == (2, 4)


@pytest.mark.parametrize("extra", [[], ["--continuous", "3", "--disaggregated"]])
def test_serve_driver_runs_deepseek_on_cpu(extra, capsys):
    out = serve_main.main(["--arch", "deepseek-v2-236b", "--smoke", "--device",
                           "cpu", "--batch", "2", "--prompt-len", "8",
                           "--gen", "4", *extra])
    printed = capsys.readouterr().out
    assert "arch=deepseek-v2-236b-smoke device=cpu" in printed
    if extra:
        assert sorted(out) == [0, 1, 2]
    else:
        assert tuple(out.shape) == (2, 4)


@pytest.mark.parametrize("extra", [[], ["--continuous", "3", "--disaggregated"]])
def test_serve_driver_runs_mamba2_on_cpu(extra, capsys):
    out = serve_main.main(["--arch", "mamba2-130m", "--smoke", "--device",
                           "cpu", "--batch", "2", "--prompt-len", "8",
                           "--gen", "4", *extra])
    printed = capsys.readouterr().out
    assert "arch=mamba2-130m-smoke device=cpu" in printed
    if extra:
        assert sorted(out) == [0, 1, 2]
    else:
        assert tuple(out.shape) == (2, 4)


@pytest.mark.parametrize("extra", [[], ["--continuous", "3", "--disaggregated"]])
def test_serve_driver_runs_jamba_on_cpu(extra, capsys):
    out = serve_main.main(["--arch", "jamba-1.5-large-398b", "--smoke",
                           "--device", "cpu", "--batch", "2", "--prompt-len",
                           "8", "--gen", "4", *extra])
    printed = capsys.readouterr().out
    assert "arch=jamba-1.5-large-398b-smoke device=cpu" in printed
    if extra:
        assert sorted(out) == [0, 1, 2]
    else:
        assert tuple(out.shape) == (2, 4)
