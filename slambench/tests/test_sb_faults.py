"""``correct`` comes out false with the timed path broken underneath: the
rest of a run (drive, engine, window, reference) on the CPU at the tiny
size, the look for a card skipped, once per fault the cells can have:
each of the three steps returning its state unchanged, an answer of each
altered where it is produced, and a fleet's batch half left out.  (The
loop tick's re-solve dropped, ``resolve_skipped``, moves nothing on this
tiny drive, whose odometry hardly drifts: it is read on the card.)"""

import pytest

from slambench import faults, run
from sb_tiny import add_cell, add_loop_cell, copy_tree

SEED = 2 ** 31 + 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("sb"))
    copy_tree(dst)
    return dst


def _run(cell, fault=None):
    if fault is None:
        return run.run_cell(cell, SEED, 3600.0, False, "cpu")
    at = cell.config["warmup_scans"] + 3
    with faults.FAULTS[fault](at):
        return run.run_cell(cell, SEED, 3600.0, False, "cpu")


def test_single_engine(tree):
    cell = add_cell(tree, "tiny1", drive_scans=12)
    sound = _run(cell)
    assert sound["correct"], sound["checks"]
    for fault in ("unchanged", "altered", "map_unchanged", "map_altered"):
        out = _run(cell, fault)
        assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("fault", [None, "loop_unchanged",
                                   "factor_altered"])
def test_loop(tree, fault):
    cell = add_loop_cell(tree, f"tinyloop_{fault}")
    out = _run(cell, fault)
    assert out["correct"] is (fault is None), out["checks"]


def test_fleet(tree):
    cell = add_cell(tree, "tiny2", engine="batch", streams=2, drive_scans=11)
    sound = _run(cell)
    assert sound["correct"], sound["checks"]
    for fault in ("unchanged", "altered", "half_batch"):
        out = _run(cell, fault)
        assert not out["correct"], (fault, out["checks"])
