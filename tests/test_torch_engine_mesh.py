"""The sharded port engine as a whole: ``SlamEngine(cfg, mesh=...)`` in 2
gloo processes, each holding half of the keyframe cloud and descriptor
banks, against the unsharded engine (driven here meanwhile) over a
12-scan drive that closes a loop (tests/torch_mesh_ranks.engine_cfg).
Every gather adds zeros to the owner's rows and every decision derives
from replicated or all-reduced values, so on the CPU the two runs agree
bit for bit: trajectories, banks, loop factors.  Then the mesh engine's
checkpoint against the unsharded engine's, and loaded back into a mesh
engine."""

import os

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.tools.dryrun_multichip import run_ranks
from sc_lego_loam_tpu_torch.utils import export, synthetic

from torch_mesh_ranks import ENGINE_SCANS, engine_cfg

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = engine_cfg()
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, ENGINE_SCANS, trajectory="straight", step=0.4, noise=0.01,
        seed=1)
    d = tmp_path_factory.mktemp("engine_mesh")
    np.savez(d / "in.npz", scans=scans, valids=valids)

    def unsharded():
        eng = SlamEngine(cfg, device="cpu")
        for i in range(ENGINE_SCANS):
            eng.process_scan(scans[i], valids[i], t=i * 0.1)
        export.save_checkpoint(str(d / "ref.npz"), eng)
        return eng

    ref = run_ranks(2, "torch_mesh_ranks:engine_rank",
                    dict(inp=str(d / "in.npz"), out=str(d / "out.npz"),
                         ckpt=str(d / "mesh_ckpt.npz")),
                    path=[TESTS], device="cpu", background=unsharded,
                    timeout=600)
    return ref, dict(np.load(d / "out.npz")), d


def test_the_drive_closes_a_loop(runs):
    ref, got, _ = runs
    assert int(ref.loops_closed) >= 1
    assert int(got["loops_closed"]) == int(ref.loops_closed)
    assert int(got["loop_ticks"]) == ref.loop_ticks == ref.map_ticks
    assert int(got["calls"]) > 0


def test_sharded_trajectory_is_bit_equal(runs):
    ref, got, _ = runs
    np.testing.assert_array_equal(got["traj"], ref.trajectory_array())
    np.testing.assert_array_equal(
        got["raw"], ref.trajectory_array(retro_correct=False))


def test_sharded_state_is_bit_equal(runs):
    """Every leaf of the mapper state, the sharded banks gathered whole
    (``checkpoint_arrays`` of the mesh engine), equals the unsharded
    engine's: the same keyframes in the same slots, the same loop
    factors, the same re-solved poses."""
    ref, got, _ = runs
    want = export.checkpoint_arrays(ref)
    have = {k[3:]: v for k, v in got.items() if k.startswith("ck.")}
    assert sorted(have) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)


def test_mesh_checkpoint_is_the_unsharded_one(runs):
    """The first process writes the mesh engine's NPZ: key for key the
    unsharded engine's file; loaded into a fresh mesh engine, each rank
    holds its own rows again, equal to the engine that saved it."""
    _, got, d = runs
    with np.load(d / "mesh_ckpt.npz") as a, np.load(d / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert bool(got["loaded_back_equal"])
