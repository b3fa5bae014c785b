"""The training path against the JAX package's, continued from
tests/test_torch_train.py (whose helpers and tolerances this file
imports): jamba-1.5-large-398b's three train steps, each taken from the
JAX step's state (``RESYNC_ARCHS``, see that file's docstring), and the
training driver on mamba2-130m's and gpt2-350m's smoke configs.  They sit
in a file of their own because the test runner spreads whole files over
its workers and, in one file, they set the suite's wall.
"""
import numpy as np
import pytest

from repro_torch.launch import train as train_main
from test_torch_train import (ADAM_TOL, RESYNC_ARCHS,
                              _assert_grads_match,
                              _assert_loss_and_grad_norm_match, _three_steps)


@pytest.fixture(scope="module", params=RESYNC_ARCHS)
def three_resynced_steps(request):
    return _three_steps(request.param, resync=True)


def test_resynced_train_step_loss_and_grad_norm_match_jax(three_resynced_steps):
    _assert_loss_and_grad_norm_match(three_resynced_steps)


def test_resynced_train_step_grads_match_jax(three_resynced_steps):
    _assert_grads_match(three_resynced_steps)


@pytest.mark.parametrize("after", [1, 3])
def test_train_step_params_of_the_hybrid_match_jax(three_resynced_steps,
                                                   after):
    """Each step from the same state: an element further from JAX's than
    the Adam tolerance is one whose first moment is within the moments'
    tolerance of 0 (1e-4 of the leaf's largest, as
    ``test_train_step_grads_match_jax``), so that the two sides may hold
    it, and Adam's direction m / sqrt(v), with other signs; it moves at
    most 2 lr, and such elements are at most 1e-4 of all."""
    rec = three_resynced_steps[after - 1]
    n_off = n_all = 0
    for got, want, m in zip(rec["port"]["params"], rec["jax"]["params"],
                            rec["jax"]["m"]):
        assert got.shape == want.shape
        off = np.abs(got - want) > ADAM_TOL["atol"] + ADAM_TOL["rtol"] * np.abs(want)
        assert (np.abs(m[off]) <= 1e-4 * np.abs(m).max()).all()
        assert np.abs(got - want).max() <= 2.5 * 3e-4
        n_off, n_all = n_off + off.sum(), n_all + off.size
    assert n_off <= 1e-4 * n_all, (n_off, n_all)


def test_train_driver_trains_mamba2(capsys):
    """mamba2-130m's smoke config through the driver: 12 steps of 8
    microbatches, the loss falling (the SSD scan's gradient is PyTorch's
    autograd through the plain version on the CPU)."""
    losses = train_main.main(["--arch", "mamba2-130m", "--smoke", "--device",
                              "cpu", "--steps", "12"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert train_main.loss_fell(losses)
    assert "arch=mamba2-130m-smoke" in capsys.readouterr().out


def test_train_driver_loss_falls(capsys):
    losses = train_main.main(["--arch", "gpt2-350m", "--smoke", "--device",
                              "cpu", "--steps", "12"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert train_main.loss_fell(losses)
    assert "last-10-mean" in capsys.readouterr().out
