"""The port's kernel dispatch feeds the observability plane's metrics as the
JAX package's does (``repro.kernels.dispatch``): with ``METRICS`` enabled,
each op counts its calls as ``ops/<op>`` under the JAX package's op names
(RMSNorm, which only the port dispatches, as ``ops/rms_norm``), one per
call the model makes; disabled, nothing is counted.  Smoke configs on the
CPU: a prefill, a decode step and a training step."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro_torch import obs
from repro_torch.configs import TrainConfig, smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch.train import to_device
from repro_torch.obs.metrics import METRICS
from repro_torch.serve import prefill, serve_step
from repro_torch.train import build_train_step, make_train_state
from repro_torch.train.optimizer import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3.2-3b", "deepseek-v2-236b", "mamba2-130m",
         "jamba-1.5-large-398b"]
# the JAX package's op names: its registry, and the MLA decode's public op
JAX_OPS = set(jdispatch.ops()) | {"mla_flash_decode"}


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the card's launch-count rule for the norms: one per norm a pass makes
_norms_per_pass = _load_chip_smoke().norms_per_pass


@pytest.fixture(autouse=True)
def _obs_off():
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()


def _ops():
    return {k[len("ops/"):]: v for k, v in METRICS.counters.items()
            if k.startswith("ops/")}


def _run(cfg, what):
    torch.manual_seed(0)
    if what == "train":
        tc = TrainConfig(global_batch=2, seq_len=32, microbatch=1, steps=1,
                         remat="block")
        state = make_train_state(cfg, tc, device="cpu")
        step, n_micro = build_train_step(cfg, tc, 2, 32)
        batch = to_device(next(SyntheticTokens(cfg, 2, 32, seed=0)), "cpu")
        obs.enable()
        step(state, batch)
        return n_micro, len(tree_leaves(state["params"]))
    params = make_train_state(cfg, TrainConfig(), device="cpu")["params"]
    prompt = torch.randint(0, cfg.vocab_size, (2, 16))
    if what == "prefill":
        obs.enable()
        prefill(cfg, params, {"tokens": prompt}, 24)
    else:
        _, cache = prefill(cfg, params, {"tokens": prompt}, 24)
        obs.enable()
        serve_step(cfg, params, prompt[:, :1], cache, 16)
    return None, None


@pytest.mark.parametrize("what", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ops_counted_per_call(arch, what):
    cfg = smoke_config(arch)
    n_attn = sum(cfg.layer_kind(l) == "attn" for l in range(cfg.num_layers))
    n_ssm = cfg.num_layers - n_attn
    n_micro, n_leaves = _run(cfg, what)
    got = _ops()
    decode = "mla_flash_decode" if cfg.attention == "mla" else "flash_decode"
    if what == "prefill":
        want = dict(attention=n_attn, ssd_scan=n_ssm,
                    rms_norm=_norms_per_pass(cfg))
    elif what == "decode":           # Mamba2's decode step is not an op
        want = {decode: n_attn, "rms_norm": _norms_per_pass(cfg)}
    else:                            # block remat: each forward op twice
        want = dict(attention=2 * n_attn * n_micro,
                    ssd_scan=2 * n_ssm * n_micro,
                    rms_norm=(2 * _norms_per_pass(cfg) - 1) * n_micro,
                    adam_update=n_leaves)
    assert got == {k: float(v) for k, v in want.items() if v}
    assert set(got) - {"rms_norm"} <= JAX_OPS


def test_nothing_counted_when_disabled():
    cfg = smoke_config("llama3.2-3b")
    params = make_train_state(cfg, TrainConfig(), device="cpu")["params"]
    prefill(cfg, params, {"tokens": torch.randint(0, cfg.vocab_size,
                                                  (2, 16))}, 24)
    assert not METRICS.enabled and _ops() == {}
