"""The control on the card: the headline cell with TF32 matmuls switched
on (the nearest precision below the float32 with TF32 off that the engine
states) must come out not correct, and the same run in float32 correct.
A short window: the published poses lose their rigidity within seconds."""

import os

import pytest

from slambench import plan, run
from sb_tiny import ROOT

CELL = "mulran-os1-64.fig8.replay"


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
def test_tf32_control_fails(card, tf32):
    cell = plan.load_cell(CELL, os.path.join(ROOT, "BENCHMARK.json"))
    out = run.run_cell(cell, 2 ** 31 + 101, 8.0, False, "cuda", tf32=tf32)
    assert out["correct"] is not tf32, out["checks"]
    rigid = out["checks"]["pose_rigidity"]
    assert (rigid["value"] > rigid["limit"]) is tf32
