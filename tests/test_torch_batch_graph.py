"""``BatchEngine``'s three batched steps as graphs (``parallel/batch.py``,
``graphs.py``) on the CPU, with ``graphs.EagerStandIn`` in place of CUDA
graph capture and replay and every loop-tick gate in its "select" mode:
the engine must equal the eager one bit for bit over a short drive and on
a closing loop tick from a hand-made state of two sequences
(tests/torch_keyframes.py), reading nothing on the host.  Also the launch
counts of conditional bodies, and the refusal to build a graphed engine
where conditional nodes cannot be captured."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch import graphs
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch
from sc_lego_loam_tpu_torch.ops import cuda_knn
from sc_lego_loam_tpu_torch.parallel import batch as tb
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.utils import convert, synthetic

# The JAX package and tests/torch_keyframes.py (which imports it) are
# imported where they are used: the card's machine has no jax, and runs
# this file's card test alone.

torch.set_num_threads(1)

SCANS = 4        # mapping ticks at scans 0 and 3, a loop tick at each


def _drive_cfg():
    """Few LM iterations (tests/test_torch_batch.py's), a loop tick every
    mapping tick, the short ICP of tests/torch_keyframes.short_loop."""
    cfg = tiny_torch()
    cfg = cfg.replace(
        cap=dataclasses.replace(cfg.cap, icp_query_pad=1024,
                                history_pad=4096),
        loop=dataclasses.replace(cfg.loop, icp_max_iterations=4),
        posegraph=dataclasses.replace(cfg.posegraph, max_gn_iterations=5))
    return cfg.replace(
        odom=dataclasses.replace(cfg.odom, max_iterations=6),
        mapping=dataclasses.replace(cfg.mapping, max_iterations=4),
        loop=dataclasses.replace(cfg.loop, check_every_ticks=1))


def _outcome(eng):
    return [eng.trajectory_array()] + [x.cpu().numpy()
                                       for x in graphs.flatten(eng.s)]


def test_drive_through_stand_in_equals_eager():
    """Two sequences over SCANS scans (the second drives the first's
    scans backwards): the graph-backed engine (static scan, ``t`` and
    index buffers; the trajectory written at the device index by every
    step) equals the eager engine bit for bit, state and trajectories."""
    cfg = _drive_cfg()
    scans, valids, _ = synthetic.make_sequence(
        cfg.lidar, SCANS, trajectory="straight", step=0.4, noise=0.01,
        seed=1)
    pts = np.stack([scans, scans[::-1]], 1)
    msk = np.stack([valids, valids[::-1]], 1)
    out = []
    for stand_in in (False, True):
        eng = tb.BatchEngine(cfg, n_seq=2, device="cpu")
        if stand_in:
            eng.use_graphs(graphs.EagerStandIn())
        fused = [eng.process_scans(pts[i], msk[i], t=i * 0.1).numpy()
                 for i in range(SCANS)]
        out.append((_outcome(eng), fused))
        assert eng._map_ticks == 2 and eng.loop_ticks == 2
    (want, fused_want), (got, fused_got) = out
    assert [g.replays for g in eng.graphs] == [SCANS - 1, 1, 2]
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    np.testing.assert_array_equal(np.stack(fused_got), np.stack(fused_want))
    np.testing.assert_array_equal(want[0][:, -1], fused_want[-1])


def _two_sequences(cfg):
    """tests/test_torch_batch_loop.py's state: sequence 0 closes a loop,
    sequence 1 has no candidate."""
    from sc_lego_loam_tpu.utils import synthetic as jsyn
    from torch_keyframes import circle, sequence, twist

    world = jsyn.default_world(seed=3)
    rng = np.random.default_rng(4)
    gt0 = circle(8)
    est0 = gt0.copy()
    est0[-1] = est0[-1] @ twist([0, 0, 0.02, 0.15, -0.1, 0])
    gt1 = np.stack([np.eye(4, dtype=np.float32)] * 3)
    gt1[:, 0, 3], gt1[:, 2, 3] = [20.0, 20.4, 20.8], 2.0
    kf0, bank0 = sequence(cfg, world, gt0, est0,
                          np.arange(8, dtype=np.float32), rng)
    kf1, bank1 = sequence(cfg, world, gt1, gt1, np.float32([0, 0.1, 0.2]),
                          rng)
    L = cfg.posegraph.max_loops
    last = np.stack([est0[-1], gt1[-1]])
    eye = np.eye(4, dtype=np.float32)
    return types.SimpleNamespace(
        kf={k: np.stack([kf0[k], kf1[k]]) for k in kf0},
        bank={k: np.stack([bank0[k], bank1[k]]) for k in bank0},
        loops=dict(i=np.zeros((2, L), np.int32), j=np.zeros((2, L), np.int32),
                   z=np.broadcast_to(eye, (2, L, 4, 4)).copy(),
                   count=np.zeros(2, np.int32)),
        pose=last, correction=np.stack([eye] * 2), last_kf_pose=last,
        last_kf_odom=last.copy())


def _loaded(cfg, st):
    eng = tb.BatchEngine(cfg, n_seq=2, device="cpu")
    odo = eng.odo
    convert.load_batch_state(eng, types.SimpleNamespace(
        odo=type(odo)(*(x.numpy() if isinstance(x, torch.Tensor) else
                        type(x)(*(y.numpy() for y in x)) for x in odo)),
        map=types.SimpleNamespace(
            kf=types.SimpleNamespace(**st.kf), correction=st.correction,
            pose=st.pose, last_kf_pose=st.last_kf_pose),
        bank=types.SimpleNamespace(**st.bank),
        loops=types.SimpleNamespace(**st.loops),
        last_kf_odom=st.last_kf_odom, loops_closed=np.zeros(2, np.int32),
        traj=eng.traj.numpy(), _scan_i=0, _map_ticks=0, last_map_time=-1e9))
    return eng


def test_closing_tick_gated_equals_eager():
    """One batched loop tick from the hand-made state: the eager tick
    (host reads) and the tick with its gates in "select" mode (under a
    guard that makes every host read raise) give the same state bit for
    bit; sequence 0 closes, sequence 1 is untouched."""
    from sc_lego_loam_tpu.config import tiny_test_config as tiny_jax
    from torch_keyframes import loop_cfg, no_host_reads, short_loop

    cfg = short_loop(loop_cfg(tiny_torch))
    st = _two_sequences(short_loop(loop_cfg(tiny_jax)))
    eager = _loaded(cfg, st)
    eager._loop_tick()
    gated = _loaded(cfg, st)
    with graphs.cond_mode("select"), no_host_reads():
        gated._loop_tick()
    for i, (a, b) in enumerate(zip(_outcome(gated)[1:],
                                   _outcome(eager)[1:])):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    assert eager.loops_closed.tolist() == [1, 0]
    np.testing.assert_array_equal(eager.map.kf.poses6.numpy()[1],
                                  st.kf["poses6"][1])


def test_body_launches_count_where_taken():
    """Launches inside ``cond`` bodies leave the host counters for the
    device counter, weighted by whether the body is taken (nested gates
    multiply); ``flush_counts`` brings them back exactly.  Eagerly they
    count on the host as they run."""
    graphs.flush_counts()
    cuda_knn.reset_launches()

    def launch(n):
        cuda_knn.launches[1] += n         # what the kNN wrapper does
        return torch.zeros(())

    def tick(outer, inner):
        return graphs.cond(outer, lambda: (launch(1) + graphs.cond(
            inner, lambda: launch(10), torch.zeros(()))), torch.zeros(()))

    t, f = torch.tensor(True), torch.tensor(False)
    with graphs.cond_mode("select"):
        for outer, inner in ((t, t), (t, f), (f, t), (f, f)):
            tick(outer, inner)
    assert cuda_knn.launches[1] == 0
    graphs.flush_counts()
    assert cuda_knn.launches[1] == (1 + 10) + 1
    for outer, inner in ((t, t), (t, f), (f, t)):
        tick(outer, inner)                # "read": host reads
    assert cuda_knn.launches[1] == 12 + 12
    cuda_knn.reset_launches()


def test_graphed_engines_refuse_without_conditional_nodes(monkeypatch):
    """No host-read fallback: where conditional nodes cannot be captured
    (no allocator switch for their bodies' streams, or CUDA before 12.4),
    building a capture backend raises; CPU engines cannot be graphed."""
    monkeypatch.delattr(torch._C, graphs._THREAD_POOL, raising=False)
    with pytest.raises(RuntimeError, match="conditional nodes"):
        graphs.CudaCapture("cuda")
    monkeypatch.undo()
    monkeypatch.setattr(torch.version, "cuda", "12.1")
    with pytest.raises(RuntimeError, match="conditional nodes"):
        graphs.require_conditional_nodes()
    cfg = tiny_torch()
    with pytest.raises(ValueError):
        tb.BatchEngine(cfg, n_seq=2, device="cpu", eager=False)
    with pytest.raises(ValueError):
        SlamEngine(cfg, device="cpu", eager=False)
    assert tb.BatchEngine(cfg, n_seq=2, device="cpu").graphs is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_graphed_batch_equals_eager_on_the_card(card):
    """The batch engine with real CUDA graphs (conditional nodes in its
    loop tick) against the eager one on the card, bit for bit."""
    cfg = _drive_cfg()
    scans, valids, _ = synthetic.make_sequence(
        cfg.lidar, 8, trajectory="straight", step=0.4, noise=0.01, seed=1)
    pts = np.stack([scans, scans[::-1]], 1)
    msk = np.stack([valids, valids[::-1]], 1)
    out = []
    for eager in (True, False):
        eng = tb.BatchEngine(cfg, n_seq=2, eager=eager)
        for i in range(8):
            eng.process_scans(pts[i], msk[i], t=i * 0.1)
        out.append(_outcome(eng))
    assert all(g.captured for g in eng.graphs)
    for a, b in zip(out[1], out[0]):
        np.testing.assert_array_equal(a, b)
