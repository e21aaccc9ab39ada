"""On the card, at each cell's own size: the control (the reference at
float8 in the program's place) fails a number of the cell on three
seeds. Run on the card with `python -m pytest perfbench/tests -m cuda`;
skips without one."""

import json
import os

import pytest

from perfbench import ROOT, harness


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]
                if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
def test_control_fails_at_the_cells_size(card, workload):
    cell = harness.Cell.load(workload)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        drv = harness.driver_class(cell.traffic)(
            cell.config, cell.traffic, seed, card, harness.say)
        got = drv.control("fp8")
        assert any(got[k] > v for k, v in cell.limits.items()), (seed, got)
