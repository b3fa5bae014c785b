"""The port's memory model (``repro_torch.core.memory_model``) against the
JAX package's (``repro.core.memory_model``): the same Python arithmetic on
the same configs, so every prediction is held equal (``==``), for all
twelve configs, whole and at smoke size, over a grid of plans; and the
analytic parameter count against the port's own ``init_params``."""
import itertools

import pytest

from repro.configs import registry as jax_registry
from repro.core import marp as jax_marp
from repro.core import memory_model as jm
from repro_torch.configs import registry
from repro_torch.core import memory_model as tm
from repro_torch.models import init_params

ARCHS = sorted(jax_registry.ARCHS)
PLANS = list(itertools.product((1, 2, 4, 8), (1, 2, 4), (0, 1, 3), (0, 1, 2)))
# (global batch, sequence) of the training predictions: the memcheck cell
# (8 x 1024) and a wider, shorter batch
TRAFFIC = ((8, 1024), (32, 256))


def _pair(arch, size):
    if size == "smoke":
        return jax_registry.smoke_config(arch), registry.smoke_config(arch)
    return jax_registry.get_arch(arch), registry.get_arch(arch)


@pytest.mark.parametrize("size", ["whole", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_counts_match_jax(arch, size):
    """analytic_param_count, the layer-kind counts and the active count
    (the JAX ``marp._active_analytic``) equal the reference's."""
    jc, tc = _pair(arch, size)
    assert tm.analytic_param_count(tc) == jm.analytic_param_count(jc)
    assert tm.layer_kind_counts(tc) == jm.layer_kind_counts(jc)
    assert tm.moe_layer_count(tc) == jm.moe_layer_count(jc)
    assert tm.active_param_count(tc) == jax_marp._active_analytic(jc)


@pytest.mark.parametrize("size", ["whole", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_training_predictions_match_jax(arch, size):
    """static_bytes, activation_bytes, exact_peak_bytes, paper_peak_bytes
    and lora_peak_bytes over d in {1, 2, 4, 8}, t in {1, 2, 4}, zero in
    {0, 1, 3} and microbatch in {0, 1, 2}, both remat modes: equal."""
    jc, tc = _pair(arch, size)
    for (batch, seq), (d, t, zero, mb) in itertools.product(TRAFFIC, PLANS):
        assert tm.static_bytes(tc, t, d, zero) == jm.static_bytes(jc, t, d, zero)
        assert tm.paper_peak_bytes(tc, batch, seq, d, t) == \
            jm.paper_peak_bytes(jc, batch, seq, d, t)
        for remat in ("block", "none"):
            kw = dict(zero=zero, microbatch=mb, remat=remat)
            assert tm.exact_peak_bytes(tc, batch, seq, d, t, **kw) == \
                jm.exact_peak_bytes(jc, batch, seq, d, t, **kw), (d, t, kw)
            if mb:
                assert tm.activation_bytes(tc, seq, mb, t, remat) == \
                    jm.activation_bytes(jc, seq, mb, t, remat)
        for rank in (8, 64):
            kw = dict(rank=rank, zero=zero, microbatch=mb)
            assert tm.lora_peak_bytes(tc, batch, seq, d, t, **kw) == \
                jm.lora_peak_bytes(jc, batch, seq, d, t, **kw)
            assert tm.lora_param_count(tc, rank) == jm.lora_param_count(jc, rank)


@pytest.mark.parametrize("size", ["whole", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_predictions_match_jax(arch, size):
    """serve_bytes_split and serve_peak_bytes over the same plans (zero
    shards the weights at 3), at a decode batch of 1 and 8 and cache
    lengths under and over a sliding window: equal."""
    jc, tc = _pair(arch, size)
    for (d, t, zero, _), batch, cache_len in itertools.product(
            PLANS, (1, 8), (12, 544, 8192)):
        args = (batch, cache_len, d, t)
        assert tm.serve_bytes_split(tc, *args, zero=zero) == \
            jm.serve_bytes_split(jc, *args, zero=zero)
        assert tm.serve_peak_bytes(tc, *args, zero=zero) == \
            jm.serve_peak_bytes(jc, *args, zero=zero)


def test_constants_match_jax():
    assert tm.XLA_RUNTIME_OVERHEAD == jm.XLA_RUNTIME_OVERHEAD
    assert not hasattr(tm, "xla_peak_bytes")


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_count_is_init_params_leaf_count(arch):
    """The prediction's parameter count is the port's own parameter tree's
    size, at smoke size (every leaf of ``init_params``)."""
    cfg = registry.smoke_config(arch)
    params = init_params(cfg, 0, device="cpu")

    def numel(t):
        return (sum(numel(v) for v in t.values()) if isinstance(t, dict)
                else t.numel())
    assert tm.analytic_param_count(cfg) == numel(params)
