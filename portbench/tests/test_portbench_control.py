"""The control at a size a test run holds: the reference computed in bf16
with fp8 convolutions and linear layers, put in the program's place, fails
each cell's limits, and reads three times the program or more on the
number that separates them.  On the card the same readings come from
``python3 portbench/control.py --workload <cell> --seeds ... --control-seeds
...`` at the cell's own size."""

from __future__ import annotations

import pytest

SEPARATES = {"stc_tt.duke-volumes": "map_gap_mean", "stc_tt.duke-volumes-fused": "map_gap_mean",
             "stc_tt.goals-train": "decoder_grad_error"}


@pytest.fixture
def bf16_root(tmp_path, monkeypatch):
    import os
    import sys

    from conftest import REPO, make_root

    root = make_root(tmp_path, dtype="bfloat16")
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.syspath_prepend(root)
    for name in [m for m in sys.modules if m == "portbench" or m.startswith("portbench.")]:
        monkeypatch.delitem(sys.modules, name)
    return os.path.join(root, "portbench")


@pytest.mark.parametrize("workload", sorted(SEPARATES))
def test_control_fails_the_limits(bf16_root, workload):
    from portbench import control, harness

    cell = harness.load_cell(workload)
    drv = harness.driver(cell["traffic_file"]["driver"])
    fn = control.serve_readings if drv.SERVES_VOLUMES else control.train_readings
    out = fn(drv, cell, 5, "cpu", True)
    assert not harness.passed(harness.compare(out["control"], cell["limits"])), out["control"]
    number = SEPARATES[workload]
    assert out["control"][number] >= 3 * out["program"][number], (out["control"], out["program"])
