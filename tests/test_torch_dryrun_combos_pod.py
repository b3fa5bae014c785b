"""Every combo of the dry run on the two-pod (2, 16, 16) mesh, as rank 0 on
the meta device: every row ``ok``, mamba2-130m's four too (none
``refused``); the checks of ``tests/test_torch_dryrun_combos.py``, which
walks the (16, 16) mesh."""
import pytest

from test_torch_dryrun_combos import (COMBOS, check_combo,  # noqa: F401
                                      memtrace_back)


@pytest.mark.parametrize("arch,shape", COMBOS,
                         ids=[f"{a}-{s}" for a, s in COMBOS])
def test_combo_on_2x16x16(arch, shape, tmp_path):
    check_combo(arch, shape, True, tmp_path)
