"""End-to-end loop closure in the port, on the CPU: the torch twin of
tests/test_loop_e2e.py.  ``SlamEngine(cfg, device="cpu")`` with loop
closure ON drives the same revisiting figure-8 (tiny sensor, thresholds
scaled as there) until Scan Context / radius search fire, ICP verifies, a
factor is inserted and the pose graph re-solved.

The path is that test's 80-pose figure-8; the drive stops after 48 scans,
ten past the first crossing of the start, which is where the loop closes:
the port runs eagerly at ~2 s a scan on one CPU thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.ops import cuda_knn
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.utils import evaluate, synthetic

torch.set_num_threads(1)

N_PATH = 80
N = 48


def _cfg(loop_enabled: bool):
    cfg = tiny_test_config()
    return cfg.replace(
        sc=dataclasses.replace(cfg.sc, exclude_recent=10),
        loop=dataclasses.replace(
            cfg.loop, enabled=loop_enabled, check_every_ticks=2,
            rs_time_gap=4.0, rs_search_radius=4.0))


@pytest.fixture(scope="module")
def seq():
    cfg = _cfg(True)
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, N_PATH, trajectory="figure8", radius=12.0, loops=1.05,
        noise=0.01, seed=3, shuffle=not cfg.lidar.ordered)
    return scans[:N], valids[:N], gt[:N]


def _run(cfg, seq):
    scans, valids, gt = seq
    engine = SlamEngine(cfg, device="cpu")
    for i in range(N):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    est = engine.trajectory_array()
    return engine, evaluate.ate_rmse(est, gt[:len(est)])


@pytest.fixture(scope="module")
def loop_run(seq):
    return _run(_cfg(True), seq)


@pytest.fixture(scope="module")
def noloop_run(seq):
    return _run(_cfg(False), seq)


def test_loop_closure_fires(loop_run):
    engine, _ = loop_run
    assert int(engine.loops_closed) >= 1, \
        "no loop closure fired on a revisiting trajectory"
    assert int(engine.loops.count) >= 1
    assert engine.loop_ticks == engine.map_ticks // 2 > 0


def test_accepted_factors_are_true(loop_run, seq):
    """The port's own precision / recall measure on the run: every
    accepted factor's Z is within 1 m of the ground-truth relative pose."""
    engine, _ = loop_run
    cfg = _cfg(True)
    pr = evaluate.loop_precision_recall(engine, seq[2], cfg)
    assert pr["accepted"] == int(engine.loops.count) >= 1
    assert pr["precision"] == 1.0, pr
    rev, n_events = evaluate.revisit_mask(seq[2], cfg.loop.rs_search_radius,
                                          min_gap=3.0)
    assert n_events == 1 and not rev[:30].any() and rev[40]


def test_loop_closure_trajectory_sane(loop_run):
    engine, ate = loop_run
    est = engine.trajectory_array()
    assert est.shape == (N, 4, 4) and np.isfinite(est).all()
    assert ate < 1.0, f"ATE with loops {ate}"
    assert np.isfinite(engine.trajectory_array(retro_correct=False)).all()


def test_loop_closure_improves_or_matches_drift(loop_run, noloop_run):
    _, ate_loop = loop_run
    engine_off, ate_free = noloop_run
    assert int(engine_off.loops_closed) == 0 and engine_off.loop_ticks == 0
    # Loop closure must not make things worse.
    assert ate_loop <= ate_free + 0.05, (ate_loop, ate_free)


def test_cpu_engine_launches_no_kernel(loop_run):
    """CPU tensors go to the plain k-NN at k=5 and k=1: no kernel launch
    is counted anywhere in the run."""
    assert cuda_knn.launches == dict.fromkeys(cuda_knn.KS, 0)
