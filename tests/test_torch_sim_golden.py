"""The port's cluster simulator, schedulers, traces and lifecycle engine
(``repro_torch.cluster``, ``repro_torch.core.lifecycle``) against the JAX
package's: one trace, drawn by each package's own generators from the same
seed, goes through both ``simulate`` calls, and every job's end state and
the run's counters are equal, bit for bit.  ``charge_overhead=False`` in
every run: with it on, the engine adds the scheduler's measured wall time
to the virtual clock, and two runs never agree.

Then the port's ``simulate_stream`` against its ``simulate``, and the
observability plane (``repro_torch.obs``) enabled on both sides: the
exported Chrome trace and metrics dump are equal once the wall-clock
slots are masked (a scheduler span's ``dur`` is the pass's measured wall
time)."""
import json

import pytest

from repro import obs as jobs_
from repro.cluster import schedulers as jsched
from repro.cluster import simulator as jsim
from repro.cluster import traces as jtraces
from repro.core import calibration as jcal
from repro.core import marp as jmarp
from repro.core import memtrace as jmt
from repro.core import orchestrator as jorch
from repro.core import reliability as jrel
from repro.obs import export as jexport
from repro_torch import obs as tobs
from repro_torch.cluster import schedulers as tsched
from repro_torch.cluster import simulator as tsim
from repro_torch.cluster import traces as ttraces
from repro_torch.core import calibration as tcal
from repro_torch.core import marp as tmarp
from repro_torch.core import memtrace as tmt
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import reliability as trel
from repro_torch.obs import export as texport

JAX = dict(sim=jsim, sched=jsched, traces=jtraces, marp=jmarp, mt=jmt,
           cal=jcal, rel=jrel, orch=jorch, obs=jobs_, export=jexport)
PORT = dict(sim=tsim, sched=tsched, traces=ttraces, marp=tmarp, mt=tmt,
            cal=tcal, rel=trel, orch=torch_orch, obs=tobs, export=texport)
SCALE_TYPES = ("RTX2080Ti", "A100-40G", "RTX6000")
SCALE_SPEC = [(6, 8, "RTX2080Ti"), (4, 8, "A100-40G"), (2, 4, "RTX6000")]
MIXED_SPEC = [(4, 4, "A100-80G"), (4, 8, "v5e")]
COUNTERS = ("sched_calls", "makespan", "preemptions", "migrations",
            "unfinished", "ooms", "oom_failures", "scale_ups", "scale_downs",
            "node_fails", "crashes", "lost_work_s")


@pytest.fixture(autouse=True)
def _clean_planes():
    """memtrace empty and off, calibration and reliability off, obs off and
    cleared, in both packages; the committed memtrace corpus seeded back
    afterwards."""
    def off(side):
        side["mt"].reset()
        side["cal"].disable()
        side["cal"].disable_decode()
        side["rel"].reset()
        side["obs"].disable()
        side["obs"].clear()
    for side in (JAX, PORT):
        off(side)
    yield
    for side in (JAX, PORT):
        off(side)
        side["mt"].seed_from_experiments()


def _placement(p):
    return p if isinstance(p, tuple) else (p.node_id, p.k, p.nbytes,
                                           p.exclusive, p.devs)


def _job_state(j):
    """tests/test_admission_scale.py's per-job tuple."""
    return (j.job_id, j.state, j.start_time, j.finish_time,
            tuple(_placement(p) for p in j.placements), j.plan_rank,
            j.preemptions, j.migrations, j.ooms, j.samples_done)


def _outcome(res):
    return (sorted(map(_job_state, res.jobs)),
            {f: getattr(res, f) for f in COUNTERS}, list(res.oom_log))


def _trace_of(jobs):
    """What a generated trace holds: arrival, kind, work and ranked plans."""
    return [(j.job_id, j.arrival, j.kind, j.total_samples, j.global_batch,
             j.seq_len, [(p.n_devices, p.min_mem, p.d, p.t, p.device_type,
                          p.pred_bytes, p.score, p.zero, p.slice_bytes)
                         for p in j.plans]) for j in jobs]


# Each scenario: side -> (jobs, nodes, scheduler, simulate kwargs), built
# from that side's own modules.

def _workload(gen, n, sched="FrenzyScheduler"):
    def build(side):
        nodes = side["orch"].make_cluster(side["orch"].PAPER_SIM_CLUSTER)
        types = sorted({n.device_type for n in nodes})
        jobs = getattr(side["traces"], gen)(n, types, seed=3)
        return jobs, nodes, getattr(side["sched"], sched)(), {}
    return build


def _churn_elastic(side):
    tr = side["traces"]
    jobs = list(tr.mixed_scale_workload_iter(150, 80, SCALE_TYPES, seed=5,
                                             mean_interarrival=0.5,
                                             mean_minutes=3.0))
    nodes = side["orch"].make_cluster(list(SCALE_SPEC))
    churn = tr.churn_schedule(nodes, horizon=max(j.arrival for j in jobs)
                              + 600.0, churn_frac=0.3, seed=5)
    return jobs, nodes, side["sched"].FrenzyScheduler(), dict(
        cluster_events=churn, elastic=True)


def _oom_replan(side):
    side["mt"].enable()              # the feedback plane reads its samples
    marp = side["marp"]

    def replan(job):
        return marp.predict_plans_shared(job.cfg, job.global_batch,
                                         job.seq_len,
                                         device_types=SCALE_TYPES,
                                         max_devices=64)
    jobs = side["traces"].scale_workload(60, SCALE_TYPES, seed=23,
                                         mean_interarrival=0.5,
                                         mean_minutes=3.0)
    oracle = side["traces"].misprediction_oracle(severity=0.6, frac=0.3,
                                                 seed=23)
    return (jobs, side["orch"].make_cluster(list(SCALE_SPEC)),
            side["sched"].FrenzyScheduler(),
            dict(oom_check_fn=oracle, replan_fn=replan))


def _serve_rates(side):
    nodes = side["orch"].make_cluster(MIXED_SPEC)
    types = sorted({n.device_type for n in nodes})
    tr = side["traces"]
    sjobs, revs = tr.serve_workload(6, types, seed=4, horizon=3600.0,
                                    start_id=1000)
    jobs = sorted(tr.new_workload(8, types, seed=4) + sjobs,
                  key=lambda j: (j.arrival, j.job_id))
    return jobs, nodes, side["sched"].FrenzyScheduler(), dict(
        rate_events=revs)


def _failures(side):
    nodes = side["orch"].make_cluster([(8, 8, "v5e")])
    tr = side["traces"]
    jobs = tr.scale_workload(40, ["v5e"], seed=2, mean_interarrival=3.0,
                             mean_minutes=30.0)
    fails = tr.failure_schedule(nodes, horizon=4 * 3600.0, seed=5,
                                mtbf_scale=0.01)
    return jobs, nodes, side["sched"].HASAdmission(), dict(
        cluster_events=fails, ckpt_policy="young_daly",
        restart_backoff_s=15.0)


def _colocate(side):
    nodes = side["orch"].make_cluster(MIXED_SPEC)
    types = sorted({n.device_type for n in nodes})
    tr = side["traces"]
    sjobs, revs = tr.serve_workload(4, types, seed=6, horizon=3600.0,
                                    start_id=100_000)
    fjobs = list(tr.finetune_workload_iter(12, types, seed=6,
                                           start_id=200_000, lora=True))
    jobs = sorted(tr.new_workload(8, types, seed=6) + sjobs + fjobs,
                  key=lambda j: (j.arrival, j.job_id))
    return jobs, nodes, side["sched"].FrenzyScheduler(), dict(
        rate_events=revs, colocate=True)


SCENARIOS = {
    "frenzy-new_workload": _workload("new_workload", 30),
    "frenzy-philly_like": _workload("philly_like", 30),
    "frenzy-helios_like": _workload("helios_like", 30),
    "churn-elastic": _churn_elastic,
    "oom-replan": _oom_replan,
    "serve-rate-events": _serve_rates,
    "failures-young-daly": _failures,
    "colocate-finetune": _colocate,
    "opportunistic": _workload("new_workload", 12, "OpportunisticScheduler"),
    "elasticflow": _workload("new_workload", 12, "ElasticFlowScheduler"),
    "sia": _workload("new_workload", 10, "SiaScheduler"),
}


def _run(side, scenario):
    jobs, nodes, sched, kw = SCENARIOS[scenario](side)
    trace = _trace_of(jobs)
    res = side["sim"].simulate(jobs, nodes, sched, charge_overhead=False, **kw)
    return trace, res


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_simulate_equal(scenario):
    jtrace, jres = _run(JAX, scenario)
    ttrace, tres = _run(PORT, scenario)
    assert ttrace == jtrace
    assert _outcome(tres) == _outcome(jres)
    assert tres.jobs                              # the run did something
    if scenario == "churn-elastic":
        assert jres.preemptions > 0
    if scenario == "oom-replan":
        assert jres.ooms > 0
    if scenario == "failures-young-daly":
        assert jres.node_fails > 0 and jres.crashes > 0
    if scenario == "serve-rate-events":
        assert jres.scale_ups > 0


def test_stream_matches_list_run():
    """The port's streamed run path against its materialized one."""
    tr, sim, orch = ttraces, tsim, torch_orch
    a = sim.simulate(tr.scale_workload(200, SCALE_TYPES, seed=7),
                     orch.make_cluster(list(SCALE_SPEC)),
                     tsched.FrenzyScheduler(), charge_overhead=False)
    b = sim.simulate_stream(tr.scale_workload_iter(200, SCALE_TYPES, seed=7),
                            orch.make_cluster(list(SCALE_SPEC)),
                            tsched.FrenzyScheduler(), charge_overhead=False)
    assert (b.n_jobs, b.n_finished, b.makespan, b.sched_calls) \
        == (200, len(a.finished), a.makespan, a.sched_calls)
    assert b.avg_jct == pytest.approx(a.avg_jct, rel=1e-12)
    assert 0 < b.peak_live_jobs < 150


# the ring capacity, series budget and sampling stride, given on every
# enable: each package's obs keeps the last values it was given, and an
# earlier test in the same process may have set its own
OBS_SETTINGS = dict(trace_capacity=1 << 16, max_points=256, sample_stride=2)


def _masked_exports(side, scenario):
    """Chrome trace and metrics dump of one obs-on run, as plain JSON, with
    the wall-clock slots (a scheduler span's ``dur``) and the registry's
    enable counter taken out."""
    side["obs"].enable(**OBS_SETTINGS)
    try:
        _run(side, scenario)
    finally:
        side["obs"].disable()
    trace = json.loads(json.dumps(side["export"].chrome_trace()))
    metrics = json.loads(json.dumps(side["export"].metrics_dump()))
    for ev in trace["traceEvents"]:
        if ev.get("cat") == "sched":
            ev["dur"] = "wall"
    del metrics["version"]
    side["obs"].clear()
    return trace, metrics


@pytest.mark.parametrize("scenario", ["churn-elastic", "oom-replan",
                                      "serve-rate-events"])
def test_obs_exports_equal(scenario):
    want = _masked_exports(JAX, scenario)
    got = _masked_exports(PORT, scenario)
    assert got == want
    cats = {ev.get("cat") for ev in got[0]["traceEvents"]}
    assert {"job", "sched"} <= cats and got[1]["counters"]


def test_obs_leaves_decisions_unchanged():
    """Telemetry is free in the port too: the same run with obs on and off
    ends in the same state."""
    off = _outcome(_run(PORT, "churn-elastic")[1])
    tobs.enable()
    try:
        on = _outcome(_run(PORT, "churn-elastic")[1])
    finally:
        tobs.disable()
    assert on == off
