"""Every combo of the dry run (``repro_torch.launch.dryrun.all_combos()``,
the JAX package's ``repro/launch/dryrun.py:180``) on the (16, 16) mesh,
as rank 0 on the meta device: every row is ``ok``, mamba2-130m's four
too (its 24 SSD heads split over 16 model ranks by heads and channels, 3
heads of 32 channels a rank: ``sharding.ssm_split``), and none is
``refused``.  A row went through the kernels' stand-ins, not the plain
versions (the kernels its path launches on the card each counted; the
SSD scan at a rank's (32, 128) for mamba2-130m), its FLOPs are positive,
its peak is at least what it held when the step began, and a train row's
collectives are counted.
``tests/test_torch_dryrun_combos_pod.py`` walks the (2, 16, 16) mesh.
"""
import pytest

from repro_torch.configs.registry import get_arch
from repro_torch.core import memtrace
from repro_torch.launch import dryrun

COMBOS = list(dryrun.all_combos())


@pytest.fixture(autouse=True)
def memtrace_back():
    """A train row records its sample to memtrace (source "dryrun"): the
    committed corpus alone afterwards, as the import left it."""
    yield
    memtrace.reset()
    memtrace.seed_from_experiments()


def check_combo(arch, shape, multi_pod, out_dir):
    rec = dryrun.run_one(arch, shape, multi_pod, str(out_dir), force=True)
    assert rec["ok"] and "refused" not in rec, rec.get("traceback", rec)
    cfg = get_arch(arch)
    kinds = {cfg.layer_kind(j) for j in range(cfg.block_period)}
    attn = "attn" in kinds
    an = rec["analysis"]
    assert an["flops"] > 0 and an["hbm_bytes"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] == rec["bytes_per_device"] >= mem["entry_bytes"]
    want = {"rms_norm"}
    if rec["kind"] == "train":
        want |= {"adam_update"}
        want |= {"flash_attention", "flash_attention_bwd"} if attn else set()
        want |= {"ssd_scan", "ssd_scan_bwd"} if "ssm" in kinds else set()
        assert rec["n_micro"] == 256 // (16 * (2 if multi_pod else 1))
        assert an["collective_counts"]["all-reduce"] > 0
        assert rec["pred_exact"] > 0 and mem["state_bytes"] > 0
    elif rec["kind"] == "prefill":
        want |= {"flash_attention"} if attn else set()
        want |= {"ssd_scan"} if "ssm" in kinds else set()
    else:
        if attn:         # a Mamba2 decode step is plain PyTorch
            want |= {"flash_decode_mla" if cfg.attention == "mla"
                     else "flash_decode_gqa"}
        assert rec["pred_serve"] > 0
    assert want <= set(an["kernel_calls"])


def test_the_walk_is_all_combos():
    """Ten configs by train_4k, prefill_32k and decode_32k, the five
    long-context ones by long_500k."""
    assert len(COMBOS) == 3 * 10 + 5
    assert sum(a == "mamba2-130m" for a, _ in COMBOS) == 4


@pytest.mark.parametrize("arch,shape", COMBOS,
                         ids=[f"{a}-{s}" for a, s in COMBOS])
def test_combo_on_16x16(arch, shape, tmp_path):
    check_combo(arch, shape, False, tmp_path)
