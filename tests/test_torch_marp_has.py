"""The port's MARP and HAS (``repro_torch.core.{marp,has}``) against the JAX
package's: the same calls give the same plans, serving plans, SLO answers
and placements, bit for bit (``==`` on floats, no tolerance), with the
calibration, memory feedback and reliability planes off and each enabled
identically on both sides.

The port's device catalog has one entry more than the reference's
(``H100-80G``), so every sweep here names the reference's device types;
``tests/test_torch_submit.py`` holds the default sweep with the port's
extra plans filtered out."""
import dataclasses
import random

import numpy as np
import pytest

from repro.configs import registry as jax_registry
from repro.core import calibration as jcal
from repro.core import devices as jdev
from repro.core import has as jhas
from repro.core import marp as jmarp
from repro.core import memtrace as jmt
from repro.core import reliability as jrel
from repro_torch.configs import registry
from repro_torch.core import calibration as tcal
from repro_torch.core import has as thas
from repro_torch.core import marp as tmarp
from repro_torch.core import memtrace as tmt
from repro_torch.core import reliability as trel

ARCHS = sorted(registry.ARCHS)
JAX_TYPES = tuple(sorted(jdev.DEVICE_TYPES))
TRAIN_POINTS = ((8, 1024), (32, 4096))          # (global batch, seq)
SERVE_POINTS = ((8, 544), (32, 4096))           # (batch, cache length)
GB = 1024 ** 3

JAX = dict(marp=jmarp, has=jhas, cal=jcal, mt=jmt, rel=jrel,
           arch=jax_registry.get_arch)
PORT = dict(marp=tmarp, has=thas, cal=tcal, mt=tmt, rel=trel,
            arch=registry.get_arch)


@pytest.fixture(autouse=True)
def _clean_planes():
    """Both packages' planes off and memtrace empty around every test; the
    committed corpus is seeded back afterwards, as import left it."""
    for side in (JAX, PORT):
        side["mt"].reset()
        side["rel"].reset()
        side["cal"].disable()
        side["cal"].disable_decode()
    yield
    for side in (JAX, PORT):
        side["mt"].reset()
        side["mt"].seed_from_experiments()
        side["rel"].reset()
        side["cal"].disable()
        side["cal"].disable_decode()


def _plan(p):
    """Every field of a ResourcePlan, in order (``slice_bytes`` too, which
    the class leaves out of its own ``==``)."""
    return None if p is None else dataclasses.astuple(p)


def _train_sweep(side, arch):
    """predict_plans over both points, zero 0/1/3, both modes and LoRA rank
    0 and 8, plus required_devices for every device type."""
    cfg = side["arch"](arch)
    marp = side["marp"]
    out = []
    for batch, seq in TRAIN_POINTS:
        for zero in (0, 1, 3):
            for mode in ("exact", "paper"):
                for lora in (0, 8):
                    out.append([_plan(p) for p in marp.predict_plans(
                        cfg, batch, seq, device_types=JAX_TYPES, zero=zero,
                        mode=mode, lora_rank=lora)])
            out.append([_plan(marp.required_devices(cfg, batch, seq, dt,
                                                    zero=zero))
                        for dt in JAX_TYPES])
    return out


def _serve_sweep(side, arch):
    """predict_serve_plans in both roles, and the SLO functions on each
    side's own top decode and prefill plans."""
    cfg = side["arch"](arch)
    marp = side["marp"]
    out = []
    for batch, cache_len in SERVE_POINTS:
        roles = {role: marp.predict_serve_plans(cfg, batch, cache_len,
                                                device_types=JAX_TYPES,
                                                role=role)
                 for role in ("decode", "prefill")}
        out.append({role: [_plan(p) for p in plans]
                    for role, plans in roles.items()})
        for plan in roles["decode"][:3]:
            rate, step_s = marp.serve_plan_capacity(cfg, plan, batch,
                                                    cache_len)
            slo = marp.default_serve_slo(cfg, plan, batch, cache_len)
            out.append((rate, step_s, slo,
                        [marp.p95_token_latency(n * rate, demand, step_s)
                         for n in (1, 2, 4)
                         for demand in (0.0, 0.5 * rate, 0.99 * rate,
                                        3.0 * rate)],
                        [marp.replicas_for_slo(rate, step_s, demand, s)
                         for demand in (0.0, 0.7 * rate, 5.0 * rate, 1e9)
                         for s in (0.0, 0.5 * slo, slo, 4.0 * slo)]))
        for plan in roles["prefill"][:3]:
            ttft = marp.default_ttft_slo(cfg, plan, cache_len / 2)
            out.append((ttft, [marp.prefill_pool_target(
                cfg, plan, rate_tok, cache_len / 2, new, s)
                for rate_tok in (0.0, 1e3, 1e5)
                for new in (1.0, 32.0) for s in (0.5 * ttft, ttft, 8 * ttft)]))
    return out


def _enable(plane):
    """Enable ``plane`` identically in both packages: calibration from the
    roofline table (and a fixed decode-efficiency table), memtrace with one
    sequence of samples recorded on both sides, reliability at a flaky
    MTBF scale."""
    if plane == "calibration":
        tables = [side["cal"].roofline_table(JAX_TYPES) for side in (JAX, PORT)]
        assert tables[0] == tables[1]
        decode = {(dt, fam): 0.40 + 0.03 * i + 0.01 * j
                  for i, dt in enumerate(JAX_TYPES)
                  for j, fam in enumerate(("dense", "moe", "ssm", "*"))}
        for side, table in zip((JAX, PORT), tables):
            side["cal"].enable(table)
            side["cal"].enable_decode(decode)
    elif plane == "memtrace":
        rng = np.random.default_rng(7)
        samples = []
        for _ in range(80):
            pred = float(rng.choice([3e9, 9e9, 3e10, 9e10, 3e11])
                         * rng.uniform(0.9, 1.1))
            samples.append((str(rng.choice(["dense", "moe", "ssm", "hybrid",
                                            "vlm", "audio"])),
                            int(rng.choice([0, 1, 3])),
                            str(rng.choice(list(JAX_TYPES) + ["*"])),
                            pred, pred * float(rng.uniform(0.8, 1.4))))
        for side in (JAX, PORT):
            side["mt"].enable()
            for s in samples:
                side["mt"].record(*s, source="oom")
    else:
        for side in (JAX, PORT):
            side["rel"].enable(mtbf_scale=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_plans_equal(arch):
    assert _train_sweep(PORT, arch) == _train_sweep(JAX, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_plans_equal(arch):
    assert _serve_sweep(PORT, arch) == _serve_sweep(JAX, arch)


@pytest.mark.parametrize("plane", ["calibration", "memtrace", "reliability"])
def test_plans_equal_with_plane_enabled(plane):
    before = [_train_sweep(PORT, a) for a in ARCHS]
    _enable(plane)
    want = [(_train_sweep(JAX, a), _serve_sweep(JAX, a)) for a in ARCHS]
    got = [(_train_sweep(PORT, a), _serve_sweep(PORT, a)) for a in ARCHS]
    assert got == want
    assert [g[0] for g in got] != before        # the plane moved the plans


# --------------------------------------------------------------- HAS ---
# The random clusters and plans of tests/test_golden_equivalence.py, drawn
# once and built in both packages.

def _random_cluster(rng, max_nodes=12):
    spec = []
    for i in range(rng.randint(1, max_nodes)):
        mem = rng.choice([16, 24, 40, 80]) * GB
        tot = rng.randint(1, 8)
        spec.append((f"n{i}", rng.choice(["X", "Y"]), mem, tot,
                     rng.randint(0, tot)))
    return spec


def _random_plan(rng, dtype):
    return dict(n_devices=rng.randint(1, 16),
                min_mem=rng.choice([8, 24, 40, 80]) * GB,
                d=1, t=1, device_type=dtype, pred_bytes=1.0, score=1.0)


def _nodes(side, spec):
    return [side["has"].Node(*s) for s in spec]


def _plans(side, specs):
    return [side["marp"].ResourcePlan(**s) for s in specs]


def _placements(alloc):
    if alloc is None:
        return None
    return (_plan(alloc.plan), tuple(
        p if isinstance(p, tuple) else (p.node_id, p.k, p.nbytes,
                                        p.exclusive, p.devs)
        for p in alloc.placements))


def _node_state(nodes):
    return [dataclasses.astuple(n) for n in nodes]


def test_place_equal():
    rng = random.Random(0)
    placed = 0
    for _ in range(4000):
        spec = _random_cluster(rng)
        pspec = _random_plan(rng, rng.choice(["X", "Y"]))
        got, want = [], []
        for side, out in ((PORT, got), (JAX, want)):
            nodes = _nodes(side, spec)
            (plan,) = _plans(side, [pspec])
            out.append(_placements(side["has"].place(plan, nodes)))
            out.append(_node_state(nodes))
        assert got == want
        placed += got[0] is not None
    assert placed > 500


def test_select_plan_and_schedule_equal():
    rng = random.Random(1)
    for _ in range(2000):
        spec = _random_cluster(rng)
        pspecs = [_random_plan(rng, rng.choice(["X", "Y"]))
                  for _ in range(rng.randint(1, 6))]
        got, want = [], []
        for side, out in ((PORT, got), (JAX, want)):
            plans = _plans(side, pspecs)
            chosen = side["has"].select_plan(plans, _nodes(side, spec))
            out.append(None if chosen is None
                       else next(i for i, p in enumerate(plans) if p is chosen))
            out.append(_placements(side["has"].schedule(plans,
                                                        _nodes(side, spec))))
        assert got == want


def test_pool_take_free_equal():
    """The golden test's take/free sequence on one pool per package: each
    random plan's availability, the idle total and every node's state equal
    after every step."""
    rng = random.Random(2)
    spec = _random_cluster(rng, max_nodes=20)
    pools = [side["has"].ClusterPool(_nodes(side, spec)) for side in (JAX, PORT)]
    for step in range(3000):
        n = pools[0].nodes[rng.choice(list(pools[0].nodes))]
        if rng.random() < 0.5 and n.idle > 0:
            op = ("take", rng.randint(1, n.idle))
        elif n.idle < n.total:
            op = ("free", rng.randint(1, n.total - n.idle))
        else:
            op = None
        pspec = _random_plan(rng, rng.choice(["X", "Y"]))
        answers = []
        for side, pool in zip((JAX, PORT), pools):
            if op is not None:
                getattr(pool, op[0])(n.node_id, op[1])
            (plan,) = _plans(side, [pspec])
            answers.append((pool.avail(plan), pool.total_idle,
                            _node_state(pool.nodes.values())))
        assert answers[0] == answers[1], step


def test_pool_schedule_apply_release_equal():
    """HAS against a long-lived pool: schedule a random ranked list, commit
    it, and release earlier commitments at random; the decisions and every
    node's state equal after every step."""
    rng = random.Random(3)
    spec = _random_cluster(rng, max_nodes=20)
    pools = [side["has"].ClusterPool(_nodes(side, spec)) for side in (JAX, PORT)]
    held = []
    for step in range(2000):
        pspecs = [_random_plan(rng, rng.choice(["X", "Y"]))
                  for _ in range(rng.randint(1, 4))]
        release = rng.randrange(len(held)) if held and rng.random() < 0.4 \
            else None
        answers = []
        for k, (side, pool) in enumerate(zip((JAX, PORT), pools)):
            if release is not None:
                pool.release(held[release][k])
            alloc = pool.schedule(_plans(side, pspecs))
            if alloc is not None:
                pool.apply(alloc.placements)
            answers.append((_placements(alloc), pool.total_idle,
                            _node_state(pool.nodes.values())))
        assert answers[0] == answers[1], step
        if release is not None:
            held.pop(release)
        if answers[0][0] is not None:
            held.append([a[0][1] for a in answers])
