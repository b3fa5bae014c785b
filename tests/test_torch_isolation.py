"""The port stands alone: importing it loads neither JAX nor the JAX package,
no source of the port (or ``chip_smoke.py``) imports either, and its copies
of the configurations equal the JAX package's field by field."""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro_torch.configs import base, registry

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serve.engine" in result["imported"]
    assert "repro_torch.kernels.dispatch" in result["imported"]
    assert "repro_torch.train.train_loop" in result["imported"]
    assert "repro_torch.launch.train" in result["imported"]
    assert "repro_torch.models.mamba2" in result["imported"]
    assert "repro_torch.kernels.ssd_scan.ssd_scan" in result["imported"]
    for name in ("core.memory_model", "core.memtrace", "core.calibration",
                 "core.devices", "ckpt.checkpoint",
                 # the control plane
                 "core.reliability", "core.marp", "core.has", "obs.trace",
                 "obs.metrics", "obs", "obs.export", "core.lifecycle",
                 "core.orchestrator", "core.serverless", "cluster.simulator",
                 "cluster.schedulers", "cluster.traces", "cluster",
                 "launch.submit",
                 # the dry run, its op analysis, the kernels' stand-ins,
                 # the run report
                 "launch.dryrun", "launch.op_analysis", "kernels.meta",
                 "obs.report", "obs.churn"):
        assert f"repro_torch.{name}" in result["imported"]
    assert result["bad"] == []


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def test_model_config_fields_match():
    ours = [(f.name, f.type, f.default) for f in dataclasses.fields(base.ModelConfig)]
    theirs = [(f.name, f.type, f.default)
              for f in dataclasses.fields(jax_base.ModelConfig)]
    assert ours == theirs


def test_train_config_fields_match():
    ours = [(f.name, f.type, f.default) for f in dataclasses.fields(base.TrainConfig)]
    theirs = [(f.name, f.type, f.default)
              for f in dataclasses.fields(jax_base.TrainConfig)]
    assert ours == theirs


def test_configs_cover_the_trained_arch():
    """The trained memory-validation model and every arch the JAX package
    assigns, with the JAX registry's lists of assigned and long-context
    archs."""
    assert "gpt2-350m" in registry.ARCHS
    assert set(jax_registry.ASSIGNED) <= set(registry.ARCHS)
    assert sorted(registry.ARCHS) == sorted(jax_registry.ARCHS)
    assert registry.ASSIGNED == jax_registry.ASSIGNED
    assert registry.LONG_CONTEXT_OK == jax_registry.LONG_CONTEXT_OK


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_configs_match(arch):
    for ours, theirs in ((registry.get_arch(arch), jax_registry.get_arch(arch)),
                         (registry.smoke_config(arch),
                          jax_registry.smoke_config(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.block_period == theirs.block_period
        assert ours.head_dim == theirs.head_dim
        assert [ours.layer_kind(l) for l in range(ours.num_layers)] == \
            [theirs.layer_kind(l) for l in range(theirs.num_layers)]
        assert [ours.layer_is_moe(l) for l in range(ours.num_layers)] == \
            [theirs.layer_is_moe(l) for l in range(theirs.num_layers)]
        assert dataclasses.asdict(ours.scaled(num_layers=4)) == \
            dataclasses.asdict(theirs.scaled(num_layers=4))
