"""One train step of the six configurations the port gained last --
stablelm-12b, llava-next-34b (its modal prefix carried in each
microbatch, labels over the whole sequence), musicgen-medium,
mixtral-8x22b, starcoder2-7b and gpt2-7b -- against the JAX package's
``build_train_step`` on their smoke configs, and the parameter counts of
all twelve against the JAX package's.

Both sides start from the JAX package's ``init_params`` in float32 and
take the same SyntheticTokens batch (global batch 4, sequence 32 with
llava's 8 modal positions, 2 microbatches).  Tolerances are
tests/test_torch_train.py's: loss and grad norm rel 1e-5; Adam's first
moment after one step from 0 is (1 - beta1) g, held at max|d| <= 1e-4 of
the leaf's largest; the second, (1 - beta2) g^2, squares the gradient's
relative error, so 2e-4; the parameters at the Adam tolerance (atol 1e-6,
rtol 1e-5) but for at most 1e-4 of the elements, whose gradient is within
rounding of 0 and which the two sides move by +-lr in opposite directions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_arch as jax_get_arch
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.launch.mesh import make_plan_mesh
from repro.models import param_count as jax_param_count
from repro.models.transformer import active_param_count as jax_active_param_count
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_state as jax_make_train_state
from repro_torch.configs import ARCHS, TrainConfig, get_arch, smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as train_main
from repro_torch.models import active_param_count, param_count
from repro_torch.train import build_train_step, init_opt_state
from repro_torch.train.optimizer import tree_leaves


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
ADAM_TOL = dict(atol=1e-6, rtol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def one_step(request):
    """One step of the JAX step (jitted, one-device mesh) and of the port's
    from the same float32 parameters on the same batch: what each side
    had after it, and the batch."""
    arch = request.param
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
    raw = next(SyntheticTokens(cfg, 4, 32, seed=0))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in raw.items()})
    state, m = step(state, {k: torch.from_numpy(v) for k, v in raw.items()})
    return dict(
        cfg=cfg, raw=raw,
        jax=dict(loss=float(jm["loss"]), gnorm=float(jm["grad_norm"]),
                 **{key: [np.array(a, np.float32) for a in
                          jax.tree.leaves(jstate["opt"][key])]
                    for key in ("m", "v")},
                 params=[np.array(a, np.float32)
                         for a in jax.tree.leaves(jstate["params"])]),
        port=dict(loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
                  **{key: [_np(t) for t in tree_leaves(state["opt"][key])]
                     for key in ("m", "v")},
                  params=[_np(t) for t in tree_leaves(state["params"])]))


def test_batch_is_the_jax_pipelines(one_step):
    """The port's SyntheticTokens gives the JAX pipeline's batch: llava's
    carries 24 text tokens, 8 modal embeddings and 32 labels (0 over the
    prefix)."""
    cfg, raw = one_step["cfg"], one_step["raw"]
    theirs = next(JaxSyntheticTokens(jax_smoke_config(cfg.name[:-6]), 4, 32,
                                     seed=0))
    assert sorted(raw) == sorted(theirs)
    for key in raw:
        np.testing.assert_array_equal(raw[key], theirs[key])
    m = cfg.num_modal_tokens
    assert raw["tokens"].shape == (4, 32 - m) and raw["labels"].shape == (4, 32)
    if m:
        assert raw["modal_embeds"].shape == (4, m, cfg.d_model)
        assert not raw["labels"][:, :m].any()


def test_train_step_loss_and_grad_norm_match_jax(one_step):
    for key in ("loss", "gnorm"):
        assert one_step["port"][key] == pytest.approx(one_step["jax"][key],
                                                      rel=1e-5)


@pytest.mark.parametrize("moment,tol", [("m", 1e-4), ("v", 2e-4)])
def test_train_step_adam_moments_match_jax(one_step, moment, tol):
    for got, want in zip(one_step["port"][moment], one_step["jax"][moment]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_train_step_params_match_jax(one_step):
    for got, want in zip(one_step["port"]["params"], one_step["jax"]["params"]):
        assert got.shape == want.shape
        off = np.abs(got - want) > ADAM_TOL["atol"] + ADAM_TOL["rtol"] * np.abs(want)
        assert off.mean() <= 1e-4, (off.sum(), off.size)
        assert np.abs(got - want).max() <= 2.5 * 3e-4


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_match_jax(arch):
    """Every config at full size: all parameters, and those active per
    token (a MoE layer's top_k routed and its shared experts)."""
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    assert param_count(cfg) == jax_param_count(jcfg)
    assert active_param_count(cfg) == jax_active_param_count(jcfg)
    if arch == "stablelm-12b":
        assert param_count(cfg) == 12_142_924_800
    if arch == "deepseek-v2-236b":
        cut = dict(num_layers=4, num_experts=16)
        assert param_count(cfg.scaled(**cut)) == 3_344_552_960
        assert active_param_count(cfg.scaled(**cut)) == 2_400_834_560


def test_train_driver_trains_llava_with_its_prefix(capsys):
    """llava-next's smoke config through the driver: each batch carries
    the modal embeddings to the device with the tokens and labels, the
    embeddings at the compute dtype, 12 steps of 8 microbatches, the loss
    falling."""
    cfg = smoke_config("llava-next-34b")
    raw = next(SyntheticTokens(cfg, 2, 40, seed=0))
    moved = train_main.to_device(raw, "cpu", torch.bfloat16)
    assert sorted(moved) == ["labels", "modal_embeds", "tokens"]
    assert moved["modal_embeds"].dtype == torch.bfloat16
    assert torch.equal(moved["modal_embeds"],
                       torch.from_numpy(raw["modal_embeds"]).bfloat16())
    losses = train_main.main(["--arch", "llava-next-34b", "--smoke", "--device",
                              "cpu", "--steps", "12", "--seq", "64"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert train_main.loss_fell(losses)
    assert "arch=llava-next-34b-smoke" in capsys.readouterr().out
