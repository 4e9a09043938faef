"""The control comes out not correct, at each cell's own size, on the
card: the float8 reference put in the training step's place, the port's
own int8 path in the predictor's.  The planted faults likewise.
``controls.py`` prints the readings of many seeds; this holds one."""

import pytest
import torch

import controls
from harness import core

CELLS = ["kitti-train-s2", "nyu-train-s2", "kitti-serve-bulk", "nyu-serve-online"]


def _fails(readings, limits):
    return any(readings[k] > lim for k, lim in limits.items())


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_limits(card, cell):
    c = core.load_cell(cell)
    r = core.Run(c, core.load_config(c["config"]), 2 ** 31 + 5, 0.0, False, card)
    if c["kind"].startswith("train"):
        out = controls.train_readings(r)
    else:
        out = controls.serve_readings(r)
    assert not _fails(out["program"], c["limits"]), out
    for name, readings in out.items():
        if name != "program" and not name.endswith("_look"):
            assert _fails(readings, c["limits"]), (name, out)
    torch.cuda.empty_cache()
