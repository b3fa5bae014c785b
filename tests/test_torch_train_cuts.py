"""chip_smoke.py's one-device training cells against the JAX package, on
the CPU.

* Every cell's config, cut as ``TRAIN_CUTS`` says, has the JAX package's
  parameter count and predicted peak (``exact_peak_bytes`` at the cell's
  traffic: global batch 8 of 1,024 tokens -- ``TRAIN_SEQ``'s where it
  differs --, microbatch 1, ZeRO 1 on one device), equal to the constants
  the script holds the card's run to (``TRAIN_PARAMS``,
  ``JAX_PREDICTED_PEAK``), and the port's count and prediction equal both.
  Every registered config has a cell, and a cut keeps every width.
* jamba-1.5-large-398b's cell shortens its layer pattern to period 2: an
  attention layer with a dense SwiGLU, then a Mamba2 layer with a MoE of 2
  experts at top-2.  At smoke widths, with the JAX package's
  ``init_params`` converted through ``interop``: the pattern, the forward's
  logits and aux loss at the model tests' tolerances
  (tests/test_torch_models.py), and three train steps against the JAX
  ``build_train_step`` at tests/test_torch_train.py's tolerances, each port
  step started from the JAX state (that file's ``RESYNC_ARCHS`` method,
  since jamba's MoE amplifies Adam's first-step sign flips at gradients
  within rounding of 0); the ops its step dispatches are the launch counts
  the script requires of the cell on the card.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import get_arch as jax_get_arch
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core.memory_model import exact_peak_bytes as jax_exact_peak_bytes
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import param_count as jax_param_count
from repro_torch import obs
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core.memory_model import exact_peak_bytes
from repro_torch.interop import params_from_numpy
from repro_torch.models import forward, param_count
from test_torch_dispatch_metrics import _ops, _run
from test_torch_train import (_assert_grads_match,
                              _assert_loss_and_grad_norm_match,
                              _assert_resynced_params_match, _three_steps)


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
JAMBA = "jamba-1.5-large-398b"
# the model tests' whole-model tolerance (tests/test_torch_models.py) and
# the MoE aux loss's (tests/test_torch_moe.py)
TOL = dict(atol=1e-4, rtol=1e-4)
AUX_TOL = 1e-5
# what a cut may change: depth, the number of routed experts and (jamba)
# the period and offset of the attention layers; never a width
CUT_FIELDS = {"num_layers", "num_experts", "attn_layer_period",
              "attn_layer_offset"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _chip_smoke()
JAMBA_CUT = CHIP_SMOKE.TRAIN_CUTS[JAMBA]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("arch", sorted(CHIP_SMOKE.TRAIN_PARAMS))
def test_cell_counts_equal_the_jax_package(arch):
    cut = CHIP_SMOKE.TRAIN_CUTS.get(arch, {})
    jcfg, cfg = jax_get_arch(arch).scaled(**cut), get_arch(arch).scaled(**cut)
    seq = CHIP_SMOKE.TRAIN_SEQ.get(arch, 1024)
    kw = dict(zero=1, microbatch=1)
    assert (param_count(cfg) == jax_param_count(jcfg)
            == CHIP_SMOKE.TRAIN_PARAMS[arch])
    assert (exact_peak_bytes(cfg, 8, seq, 1, 1, **kw)
            == jax_exact_peak_bytes(jcfg, 8, seq, 1, 1, **kw)
            == CHIP_SMOKE.JAX_PREDICTED_PEAK[arch])


def test_every_config_has_a_training_cell():
    """Twelve cells, one a registered config, each with a prediction and
    a peak taken on the card; the script runs each once."""
    cells = set(CHIP_SMOKE.TRAIN_PARAMS)
    assert cells == set(JAX_ARCHS)
    assert set(CHIP_SMOKE.JAX_PREDICTED_PEAK) == cells
    assert set(CHIP_SMOKE.ONE_DEVICE_PEAK) == cells
    assert set(CHIP_SMOKE.TRAIN_CUTS) <= cells
    later = CHIP_SMOKE.NEW_TRAIN_CELLS + CHIP_SMOKE.LAST_TRAIN_CELLS
    assert len(set(later)) == len(later) == 8
    assert cells - set(later) == {"gpt2-350m", "mamba2-130m",
                                  "deepseek-v2-236b", "stablelm-12b"}


@pytest.mark.parametrize("arch", sorted(CHIP_SMOKE.TRAIN_CUTS))
def test_cut_keeps_every_width(arch):
    cut = CHIP_SMOKE.TRAIN_CUTS[arch]
    whole, cfg = get_arch(arch), get_arch(arch).scaled(**cut)
    assert set(cut) <= CUT_FIELDS
    assert 0 < cfg.num_layers <= whole.num_layers
    if whole.num_experts:
        assert whole.num_experts >= cfg.num_experts >= cfg.top_k
    kinds = {whole.layer_kind(l) for l in range(whole.num_layers)}
    assert {cfg.layer_kind(l) for l in range(cfg.num_layers)} == kinds
    assert (any(cfg.layer_is_moe(l) for l in range(cfg.num_layers))
            == bool(whole.num_experts))


@pytest.mark.parametrize("width", ["published", "smoke"])
def test_jamba_cut_pattern_equals_jax(width):
    """Period 2, the attention at offset 0 with a dense FFN, MoE on the
    Mamba2 layer: the published block's layers 4 and 5 in kind."""
    get_j, get_t = ((jax_get_arch, get_arch) if width == "published"
                    else (jax_smoke_config, smoke_config))
    jcfg, cfg = get_j(JAMBA).scaled(**JAMBA_CUT), get_t(JAMBA).scaled(**JAMBA_CUT)
    pattern = [(cfg.layer_kind(l), cfg.layer_is_moe(l))
               for l in range(cfg.num_layers)]
    assert pattern == [(jcfg.layer_kind(l), jcfg.layer_is_moe(l))
                       for l in range(jcfg.num_layers)]
    assert pattern == [("attn", False), ("ssm", True)]
    assert cfg.block_period == jcfg.block_period == 2
    assert (cfg.num_experts, cfg.top_k) == (2, 2)


@pytest.fixture(scope="module")
def jamba_pair():
    """(jax cfg, jax params, port cfg, port params) of the cut at smoke
    widths, float32 on both sides."""
    jcfg = jax_smoke_config(JAMBA).scaled(**JAMBA_CUT)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jax_init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = smoke_config(JAMBA).scaled(**JAMBA_CUT)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu", dtype=torch.float32)
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("remat", [False, True])
def test_jamba_cut_forward_matches_jax(jamba_pair, remat):
    jcfg, jparams, cfg, params = jamba_pair
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jaux, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, _, aux = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                         remat=remat, want_aux=True)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert float(jaux) > 0
    assert aux.item() == pytest.approx(float(jaux), rel=AUX_TOL, abs=AUX_TOL)


@pytest.fixture(scope="module")
def jamba_steps():
    return _three_steps(JAMBA, resync=True, cut=JAMBA_CUT)


def test_jamba_cut_loss_and_grad_norm_match_jax(jamba_steps):
    _assert_loss_and_grad_norm_match(jamba_steps)


def test_jamba_cut_grads_match_jax(jamba_steps):
    _assert_grads_match(jamba_steps)


@pytest.mark.parametrize("after", [1, 3])
def test_jamba_cut_params_match_jax(jamba_steps, after):
    _assert_resynced_params_match(jamba_steps[after - 1])


def test_jamba_cut_step_dispatches_the_launch_counts():
    """The ops one train step of the cut dispatches (``ops/<op>``, counted
    on the CPU as the kernels' wrappers count launches on the card) are
    the counts ``phase_train`` requires of the cell a step: the attention
    and the SSD scan twice a layer a microbatch (block remat), the norms
    of ``norms_per_pass`` less the final norm's recompute, Adam once a
    leaf."""
    cfg = smoke_config(JAMBA).scaled(**JAMBA_CUT)
    obs.disable()
    obs.clear()
    try:
        n_micro, n_leaves = _run(cfg, "train")
        got = _ops()
    finally:
        obs.disable()
        obs.clear()
    assert got == dict(attention=2.0 * n_micro, ssd_scan=2.0 * n_micro,
                       rms_norm=float((2 * CHIP_SMOKE.norms_per_pass(cfg) - 1)
                                      * n_micro),
                       adam_update=float(n_leaves))
