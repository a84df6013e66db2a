"""The odometry LM's gated iterations (``odometry._lm_loop``): every
iteration after the first runs under ``graphs.cond`` on ``~done``, so a
converged LM skips the rest.  Held bit for bit against the frozen loop,
written out here as the reference: every iteration run, the state kept
with ``solver.freeze`` once converged.  Both the host-read gate ("read",
the eager engine: the loop stops) and the gate's "select" stand-in (what
a conditional node computes, as in a warm-up), for the joint LM and each
stage of the two-stage split, on a step that converges early and on one
held to ``max_iterations``.  The card test counts the conditional nodes of
a captured perception graph and its probe records."""

import dataclasses

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch import graphs, odometry, pipeline
from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.ops import solver
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.utils import synthetic

torch.set_num_threads(1)

N_SCANS = 3


def _config(joint: bool, held: bool):
    cfg = tiny_test_config()
    odom = cfg.odom
    if not joint:
        odom = dataclasses.replace(odom, joint_6dof=False,
                                   dense_queries=False)
    if held:        # no step is ever small enough: all iterations run
        odom = dataclasses.replace(odom, delta_rot_deg=0.0,
                                   delta_trans_cm=0.0)
    return cfg.replace(odom=odom)


@pytest.fixture(scope="module")
def scans():
    cfg = tiny_test_config()
    scans, valids, _ = synthetic.make_sequence(
        cfg.lidar, N_SCANS, trajectory="straight", step=0.3, yaw_rate=0.02,
        noise=0.005, seed=5)
    return [(torch.from_numpy(s), torch.from_numpy(v))
            for s, v in zip(scans, valids)]


def _lm_calls(cfg, scans):
    """The arguments of every ``_lm_loop`` call of the odometry steps after
    the first scan (which has no targets)."""
    calls, original = [], odometry._lm_loop

    def recording(*args):
        calls.append(args)
        return original(*args)

    state = odometry.init_state(cfg, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        for k, (pts, msk) in enumerate(scans):
            mp.setattr(odometry, "_lm_loop", recording if k else original)
            state = pipeline._odo_perception(cfg, pts, msk, state)[0]
    return calls


def frozen_loop(xi0, xi_anchor, tube, param_idx, terms, ocfg):
    """The reference: all ``max_iterations`` run, the state frozen once
    ``done`` holds.  Returns (xi, valid count, ``done`` after each)."""
    iteration, state = odometry._lm_iteration(xi0, xi_anchor, tube,
                                              param_idx, terms, ocfg)
    done = torch.zeros((), dtype=torch.bool)
    flags = []
    for it in range(ocfg.max_iterations):
        new_done, new_state = iteration(it, state)
        state = solver.freeze(done, state, new_state)
        done = done | new_done
        flags.append(bool(done))
    return state[0], state[1][-1].sum(), flags


def _gated(args, mode):
    """``_lm_loop`` in ``mode``; also the ``done`` of its probe records."""
    ring = graphs.ProbeRing("cpu")
    ring.set(True)
    with graphs.cond_mode(mode), graphs.probing(ring):
        xi, n = odometry._lm_loop(*args)
    records = ring.drain()["records"]
    assert {site for site, _, _ in records} <= {"perception.lm_iter"}
    return xi, n, [bool(v) for _, _, v in records]


@pytest.mark.parametrize("held", [False, True], ids=["converges", "held"])
@pytest.mark.parametrize("joint", [True, False], ids=["joint", "two_stage"])
def test_gated_lm_equals_the_frozen_loop(scans, joint, held):
    cfg = _config(joint, held)
    iters = cfg.odom.max_iterations
    calls = _lm_calls(cfg, scans)
    assert len(calls) == (N_SCANS - 1) * (1 if joint else 2)
    firsts = []
    for args in calls:
        xi_ref, n_ref, flags = frozen_loop(*args)
        first = flags.index(True) if True in flags else iters
        firsts.append(first)
        for mode in ("read", "select"):
            xi, n, probed = _gated(args, mode)
            assert torch.equal(xi, xi_ref), (mode, xi, xi_ref)
            assert torch.equal(n, n_ref), (mode, n, n_ref)
            # "read" stops at the first converged iteration; "select" runs
            # every one, as the card's graph probes every one
            ran = min(first + 1, iters) if mode == "read" else iters
            assert probed == flags[:ran], (mode, probed, flags)
        assert int(n_ref) > 0
    if held:
        assert firsts == [iters] * len(calls)
    else:       # at least one LM converged with iterations left to skip
        assert min(firsts) < iters - 1, firsts


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_perception_graph_gates_the_lm_on_the_card(card):
    """A captured perception graph holds one conditional node an LM
    iteration after the first (the tiny configuration's is the joint LM,
    and perception has no other gate); a traced graphed drive leaves one
    ``perception.lm_iter`` record an iteration, ``done`` monotone, and its
    poses equal the eager engine's bit for bit."""
    cfg = tiny_test_config()
    scans, valids, _ = synthetic.make_sequence(
        cfg.lidar, 8, trajectory="straight", step=0.3, yaw_rate=0.02,
        noise=0.005, seed=5)
    poses = {}
    for eager in (True, False):
        engine = SlamEngine(cfg, eager=eager)
        if not eager:
            engine.trace.on()
        poses[eager] = [engine.process_scan(s, v, t=0.1 * i).cpu().numpy()
                        for i, (s, v) in enumerate(zip(scans, valids))]
    for a, b in zip(poses[True], poses[False]):
        np.testing.assert_array_equal(b, a)
    perception = engine.graphs[0]
    assert perception.captured
    assert perception.census[0] == cfg.odom.max_iterations - 1
    engine.trace.off()
    view = engine.trace.drain()["scans"]
    assert len(view) == len(scans)
    skipped = 0
    for s in view:
        done = [d for _, d in s["lm"]]
        assert len(done) == cfg.odom.max_iterations
        assert done == sorted(done), done
        skipped += sum(done) - (1 if any(done) else 0)
    assert skipped > 0      # the gates were taken off on this drive
