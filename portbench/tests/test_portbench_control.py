"""The control: the reference put in the program's place, computed in the
precision below the configuration's, reads outside the cell's limits.

On the CPU at a tiny size its readings are set beside the fp32 program's;
on the card (marker ``card``) at the cells' widths and 1028 points, with a
batch that a test run holds, it must fail one of the cell's limits on
every seed."""

import pytest

from portbench.kinds import serve, train
from portbench.common import Cell, checks_of
from portbench.reference.precision import Precision
from portbench.tools.calibrate import CONTROL
from portbench_helpers import run_cpu, tiny_cell


@pytest.mark.parametrize("name", ["serve-fp32-b96", "train-fp32-b24"])
def test_control_reads_far_from_the_program_on_the_cpu(name):
    cell = tiny_cell(name)
    out = run_cpu(cell)
    x = out.extra
    if cell.traffic["kind"] == "serve":
        ctrl = serve.reference_poses(x["weights"], cell, x["pool"], x["ids"], x["pool_samples"],
                                     "cpu", Precision(CONTROL[cell.dtype]))
        c = serve.gaps(ctrl, x["reference"])
    else:
        ctrl = train.reference_steps(cell, x["weights"], x["batches"], x["draws"],
                                     Precision(CONTROL[cell.dtype]))
        c = train.gaps(ctrl, x["reference"])
    n = x["numbers"]
    assert all(c[k] >= 3 * n[k] for k in n), (c, n)


@pytest.mark.card
@pytest.mark.parametrize("name", ["serve-bf16-b96", "serve-fp32-b96", "train-fp32-b24"])
@pytest.mark.parametrize("seed", [101, 2**31 + 3, 77777])
def test_control_fails_the_cells_limits_on_the_card(card, name, seed):
    from portbench import manifest

    cell, _ = manifest.find_cell(manifest.load(), name)
    small = {"batch": 8, "crops_per_request": 8, "records": [3, 5], "warmup_requests": 1,
             "check_requests": 2} if cell.traffic["kind"] == "serve" else {"batch": 8}
    cell = Cell(cell.name, cell.config, {**cell.traffic, **small}, cell.limits)
    runner = serve if cell.traffic["kind"] == "serve" else train
    import time

    out = runner.run(cell, seed, 0.5, False, card, time.perf_counter(), yardstick=True)
    x = out.extra
    prec = Precision(CONTROL[cell.dtype])
    if runner is serve:
        ctrl = serve.reference_poses(x["weights"], cell, x["pool"], x["ids"], x["pool_samples"],
                                     card, prec)
        numbers = serve.gaps(ctrl, x["reference"], x["tier"])
    else:
        numbers = train.gaps(train.reference_steps(cell, x["weights"], x["batches"],
                                                   x["draws"], prec), x["reference"], x["tier"])
    assert not all(c.ok for c in checks_of(numbers, cell.limits)), numbers
