"""``BatchEngine(cfg, n_seq=2, mesh=...)`` with the sequences sharded over
a 'seq' mesh of 2 gloo processes, one sequence each, against one
process's ``BatchEngine(n_seq=2)`` (driven here meanwhile) over the same
4 steps of two straight drives; then ``merge_solve`` of the two chains,
each brought to every rank by ``sequence_banks``.  A rank steps its
sequence under the same vmap as one process steps both, with no
communication in a step.  A vmapped step over one sequence rounds its
batched linear algebra apart from one over two (1 ulp in 4 steps here), so
floats are held at 1e-4, tests/test_torch_batch.py's bound between a
batched sequence and the single-sequence functions; masks, counts and
indices exactly."""

import os

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.parallel import batch
from sc_lego_loam_tpu_torch.tools.dryrun_multichip import run_ranks
from sc_lego_loam_tpu_torch.utils import synthetic

from torch_mesh_ranks import merge_pair

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
STEPS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = tiny_test_config()
    seqs = [synthetic.make_sequence(cfg.lidar, STEPS, trajectory="straight",
                                    step=step, noise=0.01, seed=seed)
            for step, seed in ((0.4, 1), (0.3, 5))]
    points = np.stack([s[0] for s in seqs], 1)          # (T,S,N,3)
    masks = np.stack([s[1] for s in seqs], 1)
    d = tmp_path_factory.mktemp("batch_mesh")
    np.savez(d / "in.npz", points=points, masks=masks)

    def one_process():
        eng = batch.BatchEngine(cfg, n_seq=2, device="cpu")
        for t in range(STEPS):
            eng.process_scans(points[t], masks[t], t=t * 0.1)
        banks = [eng.sequence_banks(s) for s in (0, 1)]
        return eng, banks, merge_pair(cfg, banks)

    ref = run_ranks(2, "torch_mesh_ranks:batch_rank",
                    dict(inp=str(d / "in.npz"), out=str(d / "out.npz")),
                    path=[TESTS], device="cpu", background=one_process,
                    timeout=600)
    return ref, dict(np.load(d / "out.npz"))


def _same(a, b, what):
    if a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_seq_sharded_trajectories_match_one_process(runs):
    """The gathered (S,N,4,4) trajectories."""
    (eng, _, _), got = runs
    _same(got["traj"], eng.trajectory_array(), "traj")
    assert got["traj"].shape[:2] == (2, STEPS)


def test_seq_sharded_banks_match_one_process(runs):
    (_, banks, _), got = runs
    for s, (kf, bank) in enumerate(banks):
        assert int(kf.count) >= 1
        for name, leaf in list(kf._asdict().items()):
            _same(got[f"{s}.kf.{name}"], leaf.numpy(), name)
        for name, leaf in bank._asdict().items():
            _same(got[f"{s}.bank.{name}"], leaf.numpy(), name)


def test_merge_of_a_pair_held_on_two_ranks(runs):
    """merge_solve over the two chains, each brought from the rank that
    holds it, equals the one-process merge, and is finite."""
    (_, _, merged), got = runs
    assert np.isfinite(got["merged"]).all()
    _same(got["merged"], merged.numpy(), "merged")
