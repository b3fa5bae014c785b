"""The dry run against the card: rank 0's dry-run peak of each Fig 6 plan
(``repro_torch.launch.dryrun.memcheck_row``: the train step on the meta
device, the kernels' stand-ins allocating what the kernels allocate) plus
the row's ``base_bytes`` (what the process held before the state: cuBLAS's
workspace) within 1% (``dryrun.MEMCHECK_TOLERANCE``; the name's 10% was
the first bound) of the peak the card measured for it, the ``actual_bytes``
of ``experiments/memcheck_torch/memcheck_zero1.json`` (NVIDIA H100 80GB
HBM3, 700.00 W).  Tier-1 holds the ten ZeRO 1 rows;
``python -m repro_torch.launch.dryrun --memcheck-rows`` walks all thirty,
ZeRO 0 and 3 too.
"""
import pytest

from repro_torch.launch import dryrun

ROWS = list(dryrun.memcheck_rows(zeros=(1,)))


def test_the_rows_are_the_cards():
    assert len(ROWS) == 10
    assert {r["device"] for r in ROWS} == {"NVIDIA H100 80GB HBM3"}


@pytest.mark.parametrize("row", ROWS, ids=[
    f"{r['arch']}-b{r['batch']}-d{r['d']}-t{r['t']}" for r in ROWS])
def test_dry_run_peak_within_10pct_of_the_card(row):
    got = dryrun.memcheck_row(row)
    assert got["peak_bytes"] > 0
    assert abs(got["ratio"] - 1) <= dryrun.MEMCHECK_TOLERANCE, (
        got["peak_bytes"], row)
