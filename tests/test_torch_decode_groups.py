"""The GQA decode at the query-head groups of the serving cells, and its
launch plan.

- ``kernels.meta.gqa_block_s`` plans ``csrc/flash_decode.cu``'s split from
  the cache's slots alone: the wrapper's ``block_s`` is the same at b =
  1, 2, 8 and 16 for every served cell's cache (and a sharded rank's
  2,048, 8,192 and 32,768 slots), so a row decoded alone and in a batch
  is summed over the same splits in the same order.  (The MLA decode's
  split, deepseek-v2's, was already planned so: ``meta.mla_plan``.)
- The plain GQA decode and its split-KV form at that plan against the JAX
  package's ``gqa_decode_ref``, ``gqa_decode_splitk`` and the Pallas
  ``flash_decode_gqa`` in interpret mode, at G = H/K of 1, 6, 7, 9 and 12
  (the groups the new cells launch) and head dims 64 and 128, float32
  (2e-5) and bfloat16 (2e-2), with one row's valid slots wrapped round
  the ring's end.
- ``param_count`` of ``chip_smoke.py``'s cut mixtral-8x22b and
  llava-next-34b against the JAX package's for the same cut configs.

Inputs come from numpy with a fixed seed; bfloat16 inputs are rounded in
torch and handed to JAX through float32, which is exact.  The JAX oracles
are jitted: eager op-by-op, each new shape compiles dozens of ops.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import meta as km
from repro_torch.kernels.flash_decode import gqa_decode_ref, gqa_decode_splitk
from repro_torch.kernels.flash_decode.flash_decode import block_s
from repro_torch.models import param_count
from repro_torch.models.transformer import cache_slots


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's tests, restored after: the CPU
    ops here are small, and a pool of spinning threads per test process
    only crowds the other processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}
PROMPT, NEW = 512, 32        # chip_smoke.py's serving cells


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()


def _cell(arch, prompt=PROMPT):
    """(S, K) of an arch's serving cell: its ring's slots, KV heads."""
    cfg = get_arch(arch)
    return (cache_slots(cfg, prompt + cfg.num_modal_tokens + NEW),
            cfg.num_kv_heads)


# (name, S, K, rows a split): the GQA cells the card serves, starcoder2-7b's
# long prompt over its 4,096-slot window and a sharded rank's caches after
# the fallback's all-to-all
SPLITS = [("llama3.2-3b", *_cell("llama3.2-3b"), 64),
          ("jamba-1.5-large-398b", *_cell("jamba-1.5-large-398b"), 64),
          ("stablelm-12b", *_cell("stablelm-12b"), 64),
          ("starcoder2-7b", *_cell("starcoder2-7b"), 64),
          ("starcoder2-7b_long", *_cell("starcoder2-7b", 8192), 64),
          ("starcoder2-3b", *_cell("starcoder2-3b"), 64),
          ("gpt2-7b", *_cell("gpt2-7b"), 64),
          ("musicgen-medium", *_cell("musicgen-medium"), 64),
          ("mixtral-8x22b", *_cell("mixtral-8x22b"), 64),
          ("llava-next-34b", *_cell("llava-next-34b"), 64),
          ("rank_2048", 2048, 8, 64),
          ("rank_8192", 8192, 8, 128),
          ("rank_32768", 32_768, 8, 512)]


@pytest.mark.parametrize("name,S,K,rows", SPLITS, ids=[c[0] for c in SPLITS])
def test_gqa_split_is_the_same_at_every_batch(name, S, K, rows):
    """The wrapper's split of a (b, S, K, D) cache on the meta device at
    b = 1, 2, 8, 16: one plan, the one pinned here."""
    got = {b: block_s(torch.empty((b, S, K, 128), device="meta"))
           for b in (1, 2, 8, 16)}
    assert set(got.values()) == {rows}, got
    assert km.gqa_block_s(S) == rows


def test_mla_split_is_the_same_at_every_batch():
    """deepseek-v2's MLA decode (the eleventh cell with a decode kernel):
    its split and grid but the batch are the same at every b."""
    S, _ = _cell("deepseek-v2-236b")
    plans = {b: km.mla_plan(b, S, 128, True) for b in (1, 2, 8, 16)}
    assert len({(bs, grid[:2], fused) for bs, grid, fused
                in plans.values()}) == 1, plans


@pytest.fixture(scope="module")
def jx():
    """The JAX package's decode oracles and Pallas kernel, jitted."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode_gqa
    from repro.kernels.flash_decode import ref as fd_ref
    return dict(
        jnp=jnp, ref=jax.jit(fd_ref.gqa_decode_ref),
        splitk=jax.jit(fd_ref.gqa_decode_splitk, static_argnames="block_s"),
        pallas=jax.jit(functools.partial(flash_decode_gqa, interpret=True),
                       static_argnames="block_s"))


def _inputs(b, S, H, K, D, dtype, seed):
    """q, k, v from numpy in ``dtype``; valid: row 0's slots wrapped round
    the ring's end (its last 2S/5 slots and its first S/5), the others a
    prefix each, one of a single slot."""
    rng = np.random.default_rng(seed)
    qkv = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                            ).to(dtype)
           for s in ((b, 1, H, D), (b, S, K, D), (b, S, K, D))]
    valid = np.zeros((b, S), bool)
    valid[0, S - 2 * S // 5:] = True
    valid[0, :S // 5] = True
    for i in range(1, b):
        valid[i, :max(1, int(rng.integers(1, S + 1)) // i)] = True
    return qkv, valid


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).astype(np.float32))


# (G, D, S): each group at both head dims, the lengths 48, 300 and 640 in turn
GROUPS = [(G, D, (48, 300, 640)[(i + j) % 3])
          for i, G in enumerate((1, 6, 7, 9, 12))
          for j, D in enumerate((64, 128))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("G,D,S", GROUPS,
                         ids=[f"G{G}-D{D}-S{S}" for G, D, S in GROUPS])
def test_decode_at_group_matches_jax(jx, G, D, S, dtype):
    """b = 3 rows on K = 2 KV heads of G query heads each: the plain
    decode and the split-KV oracle at the plan's split against JAX's
    oracles and the Pallas kernel in interpret mode at the same split."""
    K = 2
    (q, k, v), valid = _inputs(3, S, G * K, K, D, DTYPES[dtype][0],
                               seed=G * 1000 + D + S)
    bs = km.gqa_block_s(S)
    tol = DTYPES[dtype][1]
    jnp = jx["jnp"]
    jargs = [jnp.asarray(t.float().numpy()).astype(dtype) for t in (q, k, v)]
    jargs.append(jnp.asarray(valid))
    tvalid = torch.from_numpy(valid)

    ref = gqa_decode_ref(q, k, v, tvalid)
    split = gqa_decode_splitk(q, k, v, tvalid, block_s=bs)
    assert ref.dtype == split.dtype == q.dtype
    np.testing.assert_allclose(_f32(ref), _f32(jx["ref"](*jargs)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(split),
                               _f32(jx["splitk"](*jargs, block_s=bs)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(split),
                               _f32(jx["pallas"](*jargs, block_s=bs)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(split), _f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch,layers", [
    ("mixtral-8x22b", CHIP_SMOKE.MIXTRAL_LAYERS),
    ("llava-next-34b", CHIP_SMOKE.LLAVA_LAYERS)])
def test_cut_config_param_count_matches_jax(arch, layers):
    """The serving phases' cut configs: the port's ``param_count`` equals
    the JAX package's for the same cut, and the count the phases print."""
    pytest.importorskip("jax")
    from repro.configs.registry import get_arch as jax_arch
    from repro.models.transformer import param_count as jax_param_count
    got = param_count(get_arch(arch).scaled(num_layers=layers))
    assert got == jax_param_count(jax_arch(arch).scaled(num_layers=layers))
    assert got == {"mixtral-8x22b": 10_418_903_040,
                   "llava-next-34b": 5_380_365_312}[arch]
