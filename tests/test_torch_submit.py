"""The port's serverless front door (``repro_torch.launch.submit``,
``repro_torch.core.{serverless,orchestrator}``) against the JAX package's:
the same submissions print the same text and leave every job in the same
state, bit for bit, after each call of a live orchestrator sequence.

Then what the port adds, its ``H100-80G`` catalog entry: on a cluster of
one H100 the training cells ``chip_smoke.py`` runs are started on plan
d=1 t=1 with the peak the card is held to as ``pred_bytes``, whole
stablelm-12b is queued, and the default sweep over the whole catalog is
the JAX package's once the H100 plans are filtered out."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

from repro.configs import registry as jax_registry
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import calibration as jcal
from repro.core import marp as jmarp
from repro.core import memtrace as jmt
from repro.core import orchestrator as jorch
from repro.core import reliability as jrel
from repro.core import serverless as jsrv
from repro.launch import submit as jsubmit
from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.core import calibration as tcal
from repro_torch.core import marp as tmarp
from repro_torch.core import memory_model as mm
from repro_torch.core import memtrace as tmt
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import reliability as trel
from repro_torch.core import serverless as tsrv
from repro_torch.launch import submit as tsubmit

ROOT = Path(__file__).resolve().parents[1]
JAX = dict(orch=jorch, srv=jsrv, arch=jax_registry.get_arch, tc=JTrainConfig,
           mt=jmt, cal=jcal, rel=jrel)
PORT = dict(orch=torch_orch, srv=tsrv, arch=registry.get_arch, tc=TrainConfig,
            mt=tmt, cal=tcal, rel=trel)
ONE_H100 = [(1, 1, "H100-80G")]


@pytest.fixture(autouse=True)
def _clean_planes():
    """An OOM report records into memtrace, and the planes are module state
    an earlier test in the process may have left on: memtrace empty,
    calibration and reliability off in both packages around each test, the
    committed memtrace corpus seeded back afterwards."""
    def off(side):
        side["mt"].reset()
        side["cal"].disable()
        side["cal"].disable_decode()
        side["rel"].reset()
    for side in (JAX, PORT):
        off(side)
    yield
    for side in (JAX, PORT):
        off(side)
        side["mt"].seed_from_experiments()


def _plan(p):
    return None if p is None else dataclasses.astuple(p)


def _job(j):
    """A job's record: identity, lifecycle state and times, placement, plan
    and counters, and the serving fields."""
    return (j.job_id, j.kind, j.state, j.arrival, j.start_time, j.finish_time,
            tuple(tuple(p) for p in j.placements), j.plan_rank,
            _plan(j.allocation.plan if j.allocation else None),
            [_plan(p) for p in j.plans], j.preemptions, j.migrations, j.ooms,
            j.samples_done, j.serve_replicas, j.request_rate, j.slo_p95_s,
            [tuple(map(tuple, r)) for r in j.replica_placements])


@pytest.mark.parametrize("cluster", sorted(tsubmit.CLUSTERS))
def test_submit_main_equal(cluster, capsys):
    argv = ["--arch", "gpt2-350m", "--arch", "llama3.2-3b", "--cluster",
            cluster]
    want = [_job(r.job) for r in jsubmit.main(argv)]
    want_out = capsys.readouterr().out
    got = [_job(r.job) for r in tsubmit.main(argv)]
    got_out = capsys.readouterr().out
    assert got_out == want_out
    assert got == want
    assert sorted(tsubmit.CLUSTERS) == sorted(jsubmit.CLUSTERS)


def _sequence(side):
    """A live orchestrator's life: three submissions, a release, a node
    leaving and joining, a node failing, an OOM report, a serving
    submission and a request-rate change; every job's record after each
    call."""
    orch = side["orch"].Orchestrator(
        side["orch"].make_cluster(side["orch"].PAPER_SIM_CLUSTER))
    srv, arch, tc = side["srv"], side["arch"], side["tc"]
    states = []

    def snap():
        jobs = sorted(orch.engine.jobs.values(), key=lambda j: j.job_id)
        states.append(([_job(j) for j in jobs],
                       [(n.node_id, n.idle) for n in orch.snapshot()]))

    subs = []
    for name, batch in (("gpt2-350m", 32), ("llama3.2-3b", 64),
                        ("stablelm-12b", 32)):
        subs.append(srv.submit(orch, arch(name), tc(global_batch=batch,
                                                    seq_len=1024, zero=1)))
        snap()
    orch.release(subs[0].job.job_id)
    snap()
    busy = subs[1].job.placements[0][0]
    orch.node_leave(busy)
    snap()
    orch.node_join(node_id=busy)
    snap()
    orch.node_fail(subs[2].job.placements[0][0])
    snap()
    victim = next(s for s in subs if s.job.state == "running")
    srv.report_oom(orch, victim, 1.5 * victim.job.allocation.plan.pred_bytes)
    snap()
    serve = srv.submit_serve(orch, arch("llama3.2-3b"), batch=8, cache_len=544)
    snap()
    orch.set_request_rate(serve.job.job_id, 5.0 * serve.job.replica_rate)
    snap()
    return states, serve.describe()


def test_orchestrator_sequence_equal():
    want, got = _sequence(JAX), _sequence(PORT)
    assert got == want
    kinds = {j[1] for j in got[0][-1][0]}
    assert kinds == {"train", "serve"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_one_h100_starts_the_training_cells():
    """The plan the port's MARP makes for the card is the plan the card
    runs: d=1 t=1 of the H100-80G, its pred_bytes the peak chip_smoke.py
    holds the card's to."""
    smoke = _chip_smoke()
    predicted, cuts = smoke.JAX_PREDICTED_PEAK, smoke.TRAIN_CUTS
    for arch, want in predicted.items():
        cfg = registry.get_arch(arch).scaled(**cuts.get(arch, {}))
        orch = torch_orch.Orchestrator(torch_orch.make_cluster(ONE_H100))
        res = tsrv.submit(orch, cfg, TrainConfig(global_batch=8, seq_len=1024,
                                                 zero=1))
        plan = res.job.allocation.plan
        assert res.started
        assert (plan.d, plan.t, plan.device_type) == (1, 1, "H100-80G")
        assert plan.pred_bytes == mm.exact_peak_bytes(cfg, 8, 1024, 1, 1,
                                                      zero=1) == want
        orch.release(res.job.job_id)
        assert res.job.state == "done"


def test_one_h100_queues_whole_stablelm():
    orch = torch_orch.Orchestrator(torch_orch.make_cluster(ONE_H100))
    res = tsrv.submit(orch, registry.get_arch("stablelm-12b"),
                      TrainConfig(global_batch=8, seq_len=1024, zero=1))
    assert res.job.state == "queued" and not res.started
    assert res.plans and min(p.n_devices for p in res.plans) >= 2
    assert mm.exact_peak_bytes(registry.get_arch("stablelm-12b"), 8, 1024,
                               1, 1, zero=1) > 245e9
    assert "queued" in res.describe()


@pytest.mark.parametrize("arch", ["gpt2-350m", "deepseek-v2-236b",
                                  "mamba2-130m", "stablelm-12b"])
def test_default_catalog_is_the_jax_one_plus_h100(arch):
    jcfg, tcfg = jax_registry.get_arch(arch), registry.get_arch(arch)
    for zero in (1, 3):
        want = [_plan(p) for p in jmarp.predict_plans(jcfg, 32, 2048,
                                                      zero=zero)]
        got = [_plan(p) for p in tmarp.predict_plans(tcfg, 32, 2048,
                                                     zero=zero)]
        assert any(p[4] == "H100-80G" for p in got)
        assert [p for p in got if p[4] != "H100-80G"] == want
    want = [_plan(p) for p in jmarp.predict_serve_plans(jcfg, 8, 2048)]
    got = [_plan(p) for p in tmarp.predict_serve_plans(tcfg, 8, 2048)]
    assert [p for p in got if p[4] != "H100-80G"] == want
