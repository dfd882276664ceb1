"""The control of each cell, at a size the CPU holds: the plain reference
one precision step lower (fp8 products; int4 weights on the int8 cell) put
in the program's place, and for training the step that leaves half of its
rays out, fail the cell's limits, where the program's own run passes
them (``test_nerfbench_run``). On the card at the cells' own size the same
readings come from ``tools/readings.py``."""

import pytest
import torch

from nerfbench import harness
from nerfbench.tests import tiny
from nerfbench.tools import readings

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def cut(name):
    _, workload, config = harness.cell(name)
    wo, co = tiny.overrides(name)
    workload = {**workload, **wo}
    for key, value in co.items():
        config = {**config, key: {**config[key], **value}}
    return workload, config


def fails(gaps, workload):
    return any(gaps[k] > lim for k, lim in workload["check"]["limits"].items())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2])
def test_the_control_fails_the_limits(cell, seed):
    workload, config = cut(cell)
    dev = torch.device("cpu")
    if workload["driver"] == "train_loop":
        for fault in (None, "half_batch"):
            assert fails(readings.control_train(cell, workload, config, seed, dev, fault),
                         workload)
    else:
        assert fails(readings.control_render(cell, workload, config, seed, dev), workload)
