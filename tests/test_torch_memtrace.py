"""The port's memory feedback plane (``repro_torch.core.memtrace``), its
MFU / decode calibration (``core.calibration``) and device catalog
(``core.devices``) against the JAX package's modules of the same names:
the same calls give equal results, bit for bit.  The one difference is
stated: the port's catalog has an ``H100-80G`` entry, the card it runs on,
so ``device_type_for`` maps an H100 there where the reference gives the
wildcard."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.configs import registry as jax_registry
from repro.core import calibration as jcal
from repro.core import devices as jdev
from repro.core import memtrace as jmt
from repro_torch.configs import registry
from repro_torch.core import calibration as tcal
from repro_torch.core import devices as tdev
from repro_torch.core import memtrace as tmt

JAX_DEVICES = sorted(jdev.DEVICE_TYPES)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@pytest.fixture(autouse=True)
def _clean_planes():
    """Each test starts from empty, disabled planes in both packages and
    leaves them as import left them: the committed corpus seeded, the
    planes off."""
    for mt in (jmt, tmt):
        mt.reset()
    yield
    for mt in (jmt, tmt):
        mt.reset()
        mt.seed_from_experiments()
    for cal in (jcal, tcal):
        cal.disable()
        cal.disable_decode()


def _samples(seed=0, n=60):
    """A fixed sequence of record() arguments: families, zero levels, device
    types (catalog names and the wildcard), predictions over several
    power-of-two buckets and observed/predicted ratios around 1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pred = float(rng.choice([3e9, 7e9, 2.5e10, 7e10]) * rng.uniform(0.9, 1.1))
        out.append((str(rng.choice(["dense", "moe", "ssm"])), int(rng.choice([0, 1, 3])),
                    str(rng.choice(["A100-40G", "A100-80G", "v5e", "*"])),
                    pred, pred * float(rng.uniform(0.7, 1.3)),
                    str(rng.choice(["xla", "memcheck", "oom"]))))
    return out


def _state(mt, queries):
    """What the plane answers: each class's correction, corrected bytes and
    margin (off, then on), the summary without its version counter, and
    the cache token's change over an enable."""
    out = []
    for enabled in (False, True):
        (mt.enable if enabled else mt.disable)()
        for fam, zero, dev, pred in queries:
            out.append((mt.correction_for(fam, zero, dev, pred),
                        mt.corrected_bytes(fam, zero, dev, pred),
                        mt.margin_for(fam, zero, dev)))
    summary = mt.stats_summary()
    v0 = summary.pop("version")
    token = mt.cache_token()
    mt.disable()
    off = mt.cache_token()
    return out, summary, (token[0], token[1] - v0), off


def test_record_sequence_gives_equal_answers():
    """The same record() calls through both planes: equal samples,
    correction_for, corrected_bytes, margin_for (off and on), summaries,
    and cache tokens (the version counters differ only by each process's
    history, so their change is compared)."""
    seq = _samples()
    queries = [(f, z, d, p) for f, z, d, p, _, _ in seq[::3]] + [
        ("dense", 1, "H100-80G", 6.7e10), ("hybrid", 0, "*", 1e9)]
    for args in seq:
        a, b = jmt.record(*args), tmt.record(*args)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [dataclasses.asdict(s) for s in jmt.samples()] == \
        [dataclasses.asdict(s) for s in tmt.samples()]
    assert _state(jmt, queries) == _state(tmt, queries)


def test_rejected_samples_and_round_trip(tmp_path):
    """Non-positive samples are refused by both; a saved sample file
    replays into the other package's plane to the same answers."""
    for mt in (jmt, tmt):
        assert mt.record("dense", 1, "v5e", 0.0, 1e9) is None
        assert mt.record("dense", 1, "v5e", 1e9, -1.0) is None
    for args in _samples(seed=1, n=20):
        jmt.record(*args)
    path = tmp_path / "samples.json"
    jmt.save(str(path))
    assert tmt.load(str(path)) == 20
    queries = [(f, z, d, p) for f, z, d, p, _, _ in _samples(seed=1, n=20)]
    jmt.reset()
    assert jmt.load(str(path)) == 20
    assert _state(jmt, queries)[0] == _state(tmt, queries)[0]


def test_seed_from_experiments_ingests_the_same_rows():
    """Both planes seed from the committed experiments/memcheck corpus
    (the port through its own registry): the same rows, the same
    answers."""
    n_j, n_t = jmt.seed_from_experiments(), tmt.seed_from_experiments()
    assert n_j == n_t > 0
    assert [dataclasses.asdict(s) for s in jmt.samples()] == \
        [dataclasses.asdict(s) for s in tmt.samples()]
    assert tmt.seed_from_experiments() == 0           # idempotent
    queries = [(f, z, "*", p) for f in ("dense", "ssm", "moe")
               for z in (0, 1) for p in (5e9, 3e10)]
    assert _state(jmt, queries) == _state(tmt, queries)


KINDS = ["TPU v5 lite", "TPU v5e", "TPU v4", "TPU v5p", "TPU v5",
         "NVIDIA A100-SXM4-40GB", "NVIDIA A100-SXM4-80GB", "NVIDIA A100 80GB PCIe",
         "NVIDIA A800-SXM4-80GB", "NVIDIA GeForce RTX 2080 Ti",
         "NVIDIA GeForce RTX 3090", "Quadro RTX 6000", "cpu", "", "TFRT_CPU_0"]


@pytest.mark.parametrize("kind", JAX_DEVICES + KINDS)
def test_device_type_for_agrees_with_jax(kind):
    assert tmt.device_type_for(kind) == jmt.device_type_for(kind)


def test_device_type_for_maps_the_h100():
    """The card the port runs on is in the port's catalog; the JAX
    catalog has no H100 and maps it to the wildcard."""
    for kind in ("NVIDIA H100 80GB HBM3", "H100-80G"):
        assert tmt.device_type_for(kind) == "H100-80G"
        assert jmt.device_type_for(kind) == jmt.ANY_DEVICE


def test_catalog_equals_jax_plus_the_h100():
    assert set(tdev.DEVICE_TYPES) == set(jdev.DEVICE_TYPES) | {"H100-80G"}
    for name, dev in jdev.DEVICE_TYPES.items():
        assert dataclasses.asdict(tdev.DEVICE_TYPES[name]) == dataclasses.asdict(dev)
    h100 = tdev.DEVICE_TYPES["H100-80G"]
    a100 = tdev.DEVICE_TYPES["A100-80G"]
    assert (h100.mem, h100.flops, h100.hbm_bw, h100.link_bw) == \
        (80 * tdev.GB, 989e12, 3.35e12, 900e9)
    assert (h100.inter_bw, h100.mtbf_s) == (a100.inter_bw, a100.mtbf_s)
    assert (tdev.TPU_PEAK_FLOPS, tdev.TPU_HBM_BW, tdev.TPU_ICI_BW) == \
        (jdev.TPU_PEAK_FLOPS, jdev.TPU_HBM_BW, jdev.TPU_ICI_BW)
    for const in ("BASE_MARGIN", "MARGIN_MIN", "MARGIN_MAX", "MARGIN_MIN_SAMPLES",
                  "MARGIN_SLACK", "CORRECTION_FLOOR", "MAX_SAMPLES", "ANY_DEVICE"):
        assert getattr(tmt, const) == getattr(jmt, const), const


# ------------------------------------------------------------ calibration --

@pytest.mark.parametrize("arch", sorted(jax_registry.ARCHS))
def test_calibration_measurements_match_jax(arch):
    """measured_mfu, measured_decode_eff, measured_prefill_eff and
    roofline_mfu of each config on every JAX catalog device: equal."""
    jc, tc = jax_registry.get_arch(arch), registry.get_arch(arch)
    for name in JAX_DEVICES:
        jd, td = jdev.DEVICE_TYPES[name], tdev.DEVICE_TYPES[name]
        for step_s, n_dev in itertools.product((0.05, 1.5, 40.0), (1, 8)):
            assert tcal.measured_mfu(step_s, tc, 8, 1024, n_dev, td) == \
                jcal.measured_mfu(step_s, jc, 8, 1024, n_dev, jd)
        for tok_s in (150.0, 2.2e4, 3e6):
            assert tcal.measured_decode_eff(tok_s, tc, 8, 544, 1, 1, td) == \
                jcal.measured_decode_eff(tok_s, jc, 8, 544, 1, 1, jd)
            assert tcal.measured_prefill_eff(tok_s, tc, 2, td) == \
                jcal.measured_prefill_eff(tok_s, jc, 2, jd)
        for seq, mb in ((2048, 1), (512, 4)):
            assert tcal.roofline_mfu(tc, td, seq=seq, microbatch=mb) == \
                jcal.roofline_mfu(jc, jd, seq=seq, microbatch=mb)


def test_calibration_tables_match_jax(tmp_path):
    """family_representatives, roofline_table over the JAX catalog,
    table_from_measurements, the lookups off and on (MFU and decode
    tables, scoped and not) and the save/load round trip: equal."""
    assert {f: c.name for f, c in tcal.family_representatives().items()} == \
        {f: c.name for f, c in jcal.family_representatives().items()}
    table = jcal.roofline_table(JAX_DEVICES)
    assert tcal.roofline_table(JAX_DEVICES) == table
    assert tcal.roofline_table(JAX_DEVICES, ["dense", "ssm"], seq=512) == \
        jcal.roofline_table(JAX_DEVICES, ["dense", "ssm"], seq=512)
    rows = [{"device_type": d, "family": f, "mfu": m} for d, f, m in
            (("v5e", "dense", 0.41), ("v5e", "dense", 0.47),
             ("A100-80G", "moe", 0.99), ("v4", "ssm", 0.001))]
    assert tcal.table_from_measurements(rows) == jcal.table_from_measurements(rows)

    def lookups(cal):
        out = [(cal.mfu_for(f, d), cal.decode_bw_for(f, d), cal.cache_token()[0])
               for f in FAMILIES for d in JAX_DEVICES]
        with cal.calibrated({("v5e", "dense"): 0.5, ("v4", "*"): 0.3}, default=0.2):
            out += [(cal.mfu_for(f, d), cal.is_enabled()) for f in FAMILIES
                    for d in JAX_DEVICES]
        cal.enable_decode({("A100-40G", "moe"): 0.6, ("v5p", "*"): 0.4})
        out += [(cal.decode_bw_for(f, d), cal.is_decode_enabled(),
                 cal.cache_token()[0]) for f in FAMILIES for d in JAX_DEVICES]
        cal.disable_decode()
        return out
    assert lookups(tcal) == lookups(jcal)
    jcal.save(str(tmp_path / "t.json"), table)
    assert tcal.load(str(tmp_path / "t.json")) == table
    for const in ("DEFAULT_MFU", "ROOFLINE_ATTAINABLE", "MIN_MFU", "MAX_MFU",
                  "DECODE_ATTAINABLE"):
        assert getattr(tcal, const) == getattr(jcal, const), const


def test_h100_calibration_is_defined():
    """The port's own entry prices the card: the serve driver's lines on
    an H100 (decode efficiency of stablelm-12b decoding 154.9 tok/s)."""
    dev = tdev.DEVICE_TYPES[tmt.device_type_for("NVIDIA H100 80GB HBM3")]
    cfg = registry.get_arch("stablelm-12b")
    eff = tcal.measured_decode_eff(154.9, cfg, 8, 544, 1, 1, dev)
    assert 0.01 < eff < 1.0
    assert 0.0 < tcal.roofline_mfu(cfg, dev) <= tcal.ROOFLINE_ATTAINABLE
