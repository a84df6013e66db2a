"""The step-graph runner (``sc_lego_loam_tpu_torch/graphs.py``) on the CPU:
its bookkeeping, with ``graphs.EagerStandIn`` in place of CUDA graph
capture and replay (a "replay" runs the step on the static buffers).

The drive is tests/torch_mesh_ranks.engine_cfg's 12 straight scans, which
close a loop at scan 10.  A runner-backed engine must equal the eager
engine bit for bit: trajectories, keyframe poses, the loop bank.  Then a
checkpoint of the eager engine before scan 10 is loaded into the runner-backed
engine, whose graphs are captured (every leaf replaced outside the graphs,
the banks included, must reach the static buffers), and its continuation
must equal the eager engine's.  The eager reference drives in a process of
its own meanwhile.  A card-only test does the same drive with real CUDA
graphs against the eager engine on the card."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch import graphs
from sc_lego_loam_tpu_torch.ops import cuda_knn
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.utils import export, synthetic

from torch_mesh_ranks import ENGINE_SCANS, engine_cfg

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
RESUME_AT = 10            # the scan the checkpoint is taken before: its
                          # mapping tick and loop tick close the loop


def _scans():
    cfg = engine_cfg()
    scans, valids, _ = synthetic.make_sequence(
        cfg.lidar, ENGINE_SCANS, trajectory="straight", step=0.4, noise=0.01,
        seed=1)
    return cfg, scans, valids


def _drive(engine, scans, valids, lo, hi):
    for i in range(lo, hi):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)


def _outcome(engine) -> dict:
    out = {"traj": engine.trajectory_array(),
           "raw": engine.trajectory_array(retro_correct=False)}
    out.update(("ck." + k, v) for k, v in
               export.checkpoint_arrays(engine).items())
    return out


def eager_reference(folder: str):
    """The eager engine over the drive (run in a process of its own): its
    checkpoint before scan ``RESUME_AT`` and its final state."""
    torch.set_num_threads(1)
    cfg, scans, valids = _scans()
    engine = SlamEngine(cfg, device="cpu")
    _drive(engine, scans, valids, 0, RESUME_AT)
    mid = os.path.join(folder, "mid.npz")
    export.save_checkpoint(mid + ".part.npz", engine)
    os.replace(mid + ".part.npz", mid)
    _drive(engine, scans, valids, RESUME_AT, ENGINE_SCANS)
    np.savez(os.path.join(folder, "eager.npz"), **_outcome(engine))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("graphs"))
    root = os.path.dirname(TESTS)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, TESTS] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    ref = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_graphs as t; "
         f"t.eager_reference({folder!r})"], env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cfg, scans, valids = _scans()
    engine = SlamEngine(cfg, device="cpu")
    engine.use_graphs(graphs.EagerStandIn())
    _drive(engine, scans, valids, 0, ENGINE_SCANS)
    runner = _outcome(engine)
    replays = [g.replays for g in engine.graphs]

    # The runner-backed engine, its graphs captured, takes the eager
    # engine's checkpoint and drives on (while the reference finishes).
    mid = os.path.join(folder, "mid.npz")
    while not os.path.exists(mid) and ref.poll() is None:
        time.sleep(0.2)
    copied = engine.graphs[1].copies.bytes
    export.load_checkpoint(mid, engine)
    _drive(engine, scans, valids, RESUME_AT, ENGINE_SCANS)
    resumed = _outcome(engine)
    log, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, log[-4000:]
    eager = dict(np.load(os.path.join(folder, "eager.npz")))
    return dict(eager=eager, runner=runner, resumed=resumed,
                replays=replays, engine=engine,
                resume_copied=engine.graphs[1].copies.bytes - copied)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_runner_drive_is_bit_equal(runs):
    """Trajectories, keyframe poses, the loop bank and every other leaf
    of the state: the runner-backed engine equals the eager one, and its
    steps did run as replays (11 perception, 3 mapping: the first call of
    each is the eager warm-up)."""
    eager, runner = runs["eager"], runs["runner"]
    assert int(eager["ck.loops_closed"]) >= 1
    assert runs["replays"] == [ENGINE_SCANS - 1, 3]
    _assert_same(runner, eager)


def test_resume_into_runner_engine_is_bit_equal(runs):
    """The checkpoint's leaves were copied into the captured graphs'
    static buffers (the keyframe banks among them), and the continuation
    equals the eager engine's bit for bit."""
    cfg = engine_cfg()
    kf_bank = (cfg.cap.max_keyframes * cfg.cap.kf_surf_pad * 3 * 4)
    assert runs["resume_copied"] >= kf_bank
    _assert_same(runs["resumed"], runs["eager"])
    engine = runs["engine"]
    for g in engine.graphs:      # the state after a replay is static
        assert g.captured
    assert engine.m.kf.surf is engine.graphs[1]._state.kf.surf


class _RecordingBackend:
    """Capture runs the function once, as CUDA graph capture does (the
    Python around the kernels runs, the counters count); replay returns
    what the capture returned."""

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        out = fn()
        return (lambda: out), 7, 0


def test_launch_counts_follow_replays():
    """A kernel counted during capture is taken back and counted once per
    replay: after n calls of a step that launches once, the count is n."""
    cuda_knn.reset_launches()

    def step(state, x):
        cuda_knn.launches[5] += 1        # what a kernel wrapper does
        return (state + x,)

    g = graphs.StepGraph(step, _RecordingBackend(), "step")
    state = torch.zeros(3)
    for n in range(1, 6):
        (state,) = g(state, torch.ones(3))
        assert cuda_knn.launches[5] == n
    assert g.delta == {("knn", 5): 1} and g.replays == 4 and g.nodes == 7
    cuda_knn.reset_launches()


def test_eager_false_raises_where_graphs_cannot_run():
    cfg = engine_cfg()
    with pytest.raises(ValueError):
        SlamEngine(cfg, device="cpu", eager=False)
    with pytest.raises(ValueError):
        SlamEngine(cfg, device="cpu", mesh=object(), eager=False)
    assert SlamEngine(cfg, device="cpu").graphs is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_cuda_graphs_equal_eager_on_the_card(card):
    """Real CUDA graphs over the drive against the eager engine on the
    card: bit for bit, and every replay launched the kNN kernel as the
    capture counted."""
    cfg, scans, valids = _scans()
    out = []
    for eager in (True, False):
        engine = SlamEngine(cfg, eager=eager)
        cuda_knn.reset_launches()
        _drive(engine, scans, valids, 0, ENGINE_SCANS)
        out.append((_outcome(engine), dict(cuda_knn.launches)))
        if not eager:
            assert all(g.captured for g in engine.graphs)
    _assert_same(out[1][0], out[0][0])
    assert out[1][1] == out[0][1]
