"""Every serving combo of the dry run resolves on rank 0: each
(``prefill_32k``, ``decode_32k``, ``long_500k``) shape of every assigned
config that ``shape_applicable`` admits -- the JAX package's
``all_combos()`` (``repro/launch/dryrun.py:180``), read from the port's
registry, whose ``ASSIGNED`` tests/test_torch_isolation.py holds equal --
on the production (16, 16) and (2, 16, 16) meshes, run as rank 0 under the
fake process group on the meta device (shapes, no data, no allocation):
the weights at their serving specs' shards (over the data axes too where
``launch.inputs.decode_inputs``' rule says so), a prefill of the rank's
rows with its caches at ``prefill_cache_specs``' shards, or one decode
step at position cache_len - 1 on a cache at ``cache_specs``' shards,
through the plain versions (``dispatch.force("ref")``: the meta device
has no kernels).  Every one runs, with its logits and every cache leaf
at the rank's shard shape: mamba2-130m's too, its 24 SSD heads split over
16 model ranks by heads and channels (``sharding.ssm_split``) and its SSD
cache state whole on every rank, as ``cache_specs`` keeps it.  No combo
raises.
"""
import pytest
import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import (ASSIGNED, get_arch, get_shape,
                                          shape_applicable)
from repro_torch.kernels import dispatch
from repro_torch.launch import memcheck
from repro_torch.launch.inputs import serve_weights_over_data
from repro_torch.launch.mesh import make_plan_mesh
from repro_torch.models.transformer import cache_shapes, local_cache_specs
from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding as sh
from repro_torch.serve import (local_serve_params, prefill, serve_parallel,
                               serve_step)
from repro_torch.models import init_cache


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file's tests, restored after: the CPU
    ops here are small, and a pool of spinning threads per test process
    only crowds the other processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
MESHES = {"16x16": (1, 16, 16), "2x16x16": (2, 16, 16)}
COMBOS = [(arch, shape, mesh) for arch in ASSIGNED for shape in SERVE_SHAPES
          for mesh in MESHES if shape_applicable(arch, shape)]


def _shard_shapes(cfg, shape, mesh, cache):
    """The cache leaves whose shapes are not their specs' shards."""
    sizes = sh.axis_sizes(mesh)
    cache_len = shape.cache_len or shape.seq_len
    specs = local_cache_specs(cfg, shape.global_batch, cache_len, sizes)
    bad = []
    for sub, leaves in cache_shapes(cfg, shape.global_batch,
                                    cache_len).items():
        for name, whole in leaves.items():
            want = col.local_shape(whole, specs[sub][name], sizes)
            if tuple(cache[sub][name].shape) != want:
                bad.append((sub, name, tuple(cache[sub][name].shape), want))
    return bad


def _rank0(arch, shape_name, mesh_name):
    cfg, shape = get_arch(arch), get_shape(shape_name)
    pods, d, t = MESHES[mesh_name]
    B = shape.global_batch
    cache_len = shape.cache_len or shape.seq_len
    # the meta device has no kernels: the plain versions give the shapes
    with memcheck.fake_world(pods * d * t), dispatch.force("ref"):
        mesh = make_plan_mesh(d, t, device_type="cpu", pods=pods)
        zero_data = shape.kind == "decode" and serve_weights_over_data(
            cfg, mesh)
        par = serve_parallel(cfg, mesh, B, cache_len, zero_data=zero_data)
        params = local_serve_params(cfg, 0, mesh, zero_data=zero_data,
                                    device="meta")
        nd = pods * d
        b = B // nd if B % nd == 0 else B
        if shape.kind == "prefill":
            tokens = torch.empty((b, shape.seq_len - cfg.num_modal_tokens),
                                 dtype=torch.long, device="meta")
            batch = {"tokens": tokens}
            if cfg.num_modal_tokens:
                batch["modal_embeds"] = torch.empty(
                    (b, cfg.num_modal_tokens, cfg.d_model),
                    dtype=torch.bfloat16, device="meta")
            logits, cache = prefill(cfg, params, batch, cache_len, par)
        else:
            cache = init_cache(cfg, B, cache_len, device="meta", par=par)
            tokens = torch.empty((b, 1), dtype=torch.long, device="meta")
            logits, cache = serve_step(cfg, params, tokens, cache,
                                       cache_len - 1, par)
        v = cfg.vocab_size // t if cfg.vocab_size % t == 0 else \
            cfg.vocab_size
        assert tuple(logits.shape) == (b, 1, v)
        return _shard_shapes(cfg, shape, mesh, cache)


@pytest.mark.parametrize("arch,shape,mesh", COMBOS,
                         ids=["-".join(c) for c in COMBOS])
def test_serving_combo_resolves_on_rank0(arch, shape, mesh):
    assert _rank0(arch, shape, mesh) == []


def test_every_serving_combo_is_walked():
    """The walk covers the dry run's serving combos: 12 configs by
    prefill_32k and decode_32k and the 5 long-context ones by long_500k,
    on both meshes."""
    assert set(SERVE_SHAPES) <= set(INPUT_SHAPES)
    assert len(COMBOS) == 2 * (2 * len(ASSIGNED) + 5)


def test_run_serve_refuses_the_cpu():
    """``launch.memcheck --shape`` measures the card's allocator: off CUDA
    it raises before it draws anything."""
    with pytest.raises(ValueError, match="CUDA"):
        memcheck.run_serve("llama3.2-3b", "decode_32k", 16, 16, device="cpu")
