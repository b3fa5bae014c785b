"""The one-device step's stacked block leaves: each layer's gradient is added
into the leaf's fp32 sum by the backward of its view
(``transformer.grad_sinks``, ``_UnbindInto``), where ``unbind``'s backward
would stack every layer's gradient into a new tensor, the leaf's gradient
held twice, before the step adds it.  Held here: the sums equal the
stacked gradients' bit for bit (smoke configs of the dense and MoE
families), the sunk leaf keeps no gradient, and without an open sum (the
sharded step, serving) the views are ``unbind``'s.  The one-device step
is held to the JAX package's in ``tests/test_torch_train.py`` and the
files beside it."""
from contextlib import contextmanager

import pytest
import torch

from repro_torch.configs import TrainConfig, smoke_config
from repro_torch.models import transformer as tr
from repro_torch.train import train_loop as tl
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import accumulate_grads, make_train_state


@contextmanager
def _no_sinks(pairs):
    yield set()


def _grads(cfg, sinks, monkeypatch):
    if not sinks:
        monkeypatch.setattr(tl, "grad_sinks", _no_sinks)
    tc = TrainConfig(global_batch=2, seq_len=16, microbatch=1, remat="block")
    state = make_train_state(cfg, tc, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=gen)}
    grads, loss = accumulate_grads(cfg, tc, state["params"], batch, 2)
    monkeypatch.undo()
    return tree_leaves(grads), loss, state["params"]


@pytest.mark.parametrize("arch", ["starcoder2-3b", "mixtral-8x22b"])
def test_sums_equal_the_stacked_gradients(arch, monkeypatch):
    cfg = smoke_config(arch)
    got, loss, params = _grads(cfg, True, monkeypatch)
    want, want_loss, _ = _grads(cfg, False, monkeypatch)
    assert torch.equal(loss, want_loss)
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(p.grad is None for p in tree_leaves(params))


def test_a_sunk_leaf_adds_its_layers_into_the_sum():
    """Three layers of a stacked leaf: under an open sum the layers'
    gradients land in it (on top of what it held), the leaf gets none;
    with no sum open, or no gradient, the views are ``unbind``'s."""
    leaf = torch.randn(3, 4, 4, requires_grad=True)
    x = torch.randn(2, 4)

    def run(w):
        h = x
        for p in tr.layer_params({"w": w}):
            h = torch.tanh(h @ p["w"])
        return h.sum()

    other = leaf.detach().clone().requires_grad_(True)
    run(other).backward()
    acc = torch.ones(3, 4, 4)
    with tr.grad_sinks([(leaf, acc)]) as sunk:
        views = tr.layer_params({"w": leaf})
        assert views[0]["w"].grad_fn.name().startswith("_UnbindInto")
        run(leaf).backward()
        assert sunk == {id(leaf)}
        with torch.no_grad():
            assert tr.layer_params({"w": leaf})[0]["w"].grad_fn is None
    assert leaf.grad is None
    assert torch.equal(acc, 1 + other.grad)
    assert tr.layer_params({"w": leaf})[0]["w"].grad_fn.name() == \
        "UnbindBackward0"
