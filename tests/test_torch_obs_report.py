"""The port's run report (``repro_torch.obs.report``) and per-op timing
(``ops_s/<op>``) against the JAX package's.

* ``report()`` prints the JAX ``report()``'s text, character for
  character, on the same exported files: the churn + OOM demo's, a
  serving and training run's with kernel op counters and timings, and
  empty ones.
* ``_demo()`` passes its four checks and returns 0; the port's
  ``churn_oom_sim`` gives the JAX one's ``SimResult`` (every job's end
  state, the counters, the OOM log).
* With ``op_timing`` on, each ``ops/<op>`` counter has as many
  ``ops_s/<op>`` samples (one host time a call), as the JAX dispatch
  records them; with it off there is no ``ops_s/`` histogram
  (``tests/test_obs.py``'s check of the JAX package); a call on meta
  tensors counts but is not timed, as the JAX package does not time a
  call under a trace.
"""
import io
import json

import pytest
import torch

from benchmarks.obs_overhead import churn_oom_sim as jax_churn_oom_sim
from repro import obs as jobs_
from repro.core import calibration as jcal
from repro.core import memtrace as jmt
from repro.core import reliability as jrel
from repro.obs import report as jreport
from repro_torch import obs as tobs
from repro_torch.configs import TrainConfig, smoke_config
from repro_torch.core import calibration as tcal
from repro_torch.core import memtrace as tmt
from repro_torch.core import reliability as trel
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import dispatch
from repro_torch.launch.train import compute_dtype, to_device
from repro_torch.obs import report as treport
from repro_torch.obs.churn import churn_oom_sim
from repro_torch.obs.export import export_chrome_trace, export_metrics
from repro_torch.obs.metrics import METRICS
from repro_torch.serve import prefill, serve_step
from repro_torch.train import build_train_step, make_train_state

SIDES = ((jmt, jcal, jrel, jobs_), (tmt, tcal, trel, tobs))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the CPU ops here are small, and a pool
    of spinning threads per test process only crowds the other processes
    of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_planes():
    """memtrace empty and off, calibration and reliability off, obs off and
    cleared, in both packages; the committed memtrace corpus seeded back
    afterwards (``tests/test_torch_sim_golden.py``'s rule)."""
    def off():
        for mt, cal, rel, ob in SIDES:
            mt.reset()
            cal.disable()
            cal.disable_decode()
            rel.reset()
            ob.disable()
            ob.clear()
    off()
    yield
    off()
    for mt, *_ in SIDES:
        mt.seed_from_experiments()


def _exports(tmp_path, name):
    tpath, mpath = tmp_path / f"{name}_trace.json", tmp_path / f"{name}.json"
    export_chrome_trace(str(tpath))
    export_metrics(str(mpath))
    return json.loads(tpath.read_text()), json.loads(mpath.read_text())


def _texts(trace, metrics, top=10):
    mine, theirs = io.StringIO(), io.StringIO()
    treport.report(trace, metrics, top=top, out=mine)
    jreport.report(trace, metrics, top=top, out=theirs)
    return mine.getvalue(), theirs.getvalue()


def _serve_and_train():
    """llama3.2-3b smoke: a prefill, two decode steps and a train step of
    two microbatches through the kernel dispatch, on the CPU."""
    cfg = smoke_config("llama3.2-3b")
    torch.manual_seed(0)
    params = make_train_state(cfg, TrainConfig(), device="cpu")["params"]
    prompt = torch.randint(0, cfg.vocab_size, (2, 16))
    _, cache = prefill(cfg, params, {"tokens": prompt}, 24)
    for pos in (16, 17):
        _, cache = serve_step(cfg, params, prompt[:, :1], cache, pos)
    tc = TrainConfig(global_batch=2, seq_len=32, microbatch=1, steps=1)
    state = make_train_state(cfg, tc, device="cpu")
    step, _ = build_train_step(cfg, tc, 2, 32)
    step(state, to_device(next(SyntheticTokens(cfg, 2, 32, seed=0)), "cpu",
                          compute_dtype(state)))


def test_report_text_equals_jax_on_the_demo_exports(tmp_path):
    tobs.enable()
    churn_oom_sim(n_nodes=60, n_jobs=120)
    tobs.disable()
    trace, metrics = _exports(tmp_path, "demo")
    for top in (3, 10):
        mine, theirs = _texts(trace, metrics, top)
        assert mine == theirs
        assert "scheduler wall time by kind:" in mine


def test_report_text_equals_jax_with_op_timings(tmp_path):
    tobs.enable(op_timing=True)
    _serve_and_train()
    tobs.disable()
    trace, metrics = _exports(tmp_path, "ops")
    mine, theirs = _texts(trace, metrics)
    assert mine == theirs
    assert "ops_s/attention: n=" in mine and "kernel op calls: " in mine


@pytest.mark.parametrize("which", ["both empty", "trace only", "metrics only"])
def test_report_text_equals_jax_on_sparse_exports(tmp_path, which):
    tobs.enable()
    churn_oom_sim(n_nodes=20, n_jobs=30)
    tobs.disable()
    trace, metrics = _exports(tmp_path, "sparse")
    trace, metrics = {"both empty": ({}, {}), "trace only": (trace, {}),
                      "metrics only": ({}, metrics)}[which]
    mine, theirs = _texts(trace, metrics)
    assert mine == theirs


def test_demo_passes_its_checks():
    out = io.StringIO()
    assert treport._demo(out=out) == 0
    text = out.getvalue()
    assert "demo round trip ok" in text and "DEMO FAILED" not in text
    assert treport.main(["--demo"]) == 0


def test_sparkline_equals_jax():
    for values in ([], [1.0], [3.0, 1.0, 2.0], [float(i % 7) for i in
                                                range(200)]):
        assert treport._sparkline(values) == jreport._sparkline(values)


def _outcome(res):
    jobs = sorted((j.job_id, j.state, j.start_time, j.finish_time,
                   j.preemptions, j.migrations, j.ooms, j.samples_done)
                  for j in res.jobs)
    counters = {f: getattr(res, f) for f in (
        "sched_calls", "makespan", "preemptions", "migrations", "unfinished",
        "ooms", "oom_failures")}
    return jobs, counters, list(res.oom_log)


def test_churn_oom_sim_equals_jax():
    assert _outcome(churn_oom_sim(n_nodes=60, n_jobs=120)) == _outcome(
        jax_churn_oom_sim(n_nodes=60, n_jobs=120))


def _op_counts():
    ops = {k[4:]: v for k, v in METRICS.counters.items()
           if k.startswith("ops/")}
    times = {k[6:]: h.total for k, h in METRICS.hists.items()
             if k.startswith("ops_s/")}
    return ops, times


def test_op_timing_samples_every_call():
    tobs.enable(op_timing=True)
    _serve_and_train()
    ops, times = _op_counts()
    assert set(ops) == {"attention", "flash_decode", "rms_norm",
                        "adam_update"}
    assert times == ops
    assert all(METRICS.hists["ops_s/" + k].sum >= 0.0 for k in ops)


def test_no_op_timing_without_the_flag():
    tobs.enable()
    _serve_and_train()
    ops, times = _op_counts()
    assert ops and times == {}
    tobs.disable()
    tobs.clear()
    _serve_and_train()
    assert _op_counts() == ({}, {})


def test_meta_calls_count_but_are_not_timed():
    tobs.enable(op_timing=True)
    q = torch.empty((1, 16, 2, 32), dtype=torch.bfloat16, device="meta")
    dispatch.attention(q, q, q)
    dispatch.rms_norm(q, torch.empty((32,), device="meta"))
    ops, times = _op_counts()
    assert ops == {"attention": 1.0, "rms_norm": 1.0} and times == {}
