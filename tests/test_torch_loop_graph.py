"""The loop tick gated on the device (``graphs.cond``): the port's
counterpart of the JAX package's ``lax.cond`` gates in ``loop.device_tick``
and of its per-iteration GN gates in ``posegraph.solve``.

On the card a captured ``loop_step`` turns each gate into a CUDA-graph
conditional node; here its "select" stand-in (run the body, keep its
values only where the flag holds: what the node computes) must equal the
eager tick, whose gates are host reads, bit for bit, and must read nothing
on the host.  States are hand-made keyframe stores (tests/torch_keyframes.py):
a tick without a candidate, one whose candidate the ICP rejects, one that
closes a loop.  One gated ``loop_step`` is held against the JAX package's
on the closing state at tests/test_torch_loop.py's tolerance."""

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch import graphs, pipeline as tp, posegraph as tpg
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch
from sc_lego_loam_tpu_torch.utils import convert, se3 as tse3

# The JAX package and tests/torch_keyframes.py (which imports it) are
# imported where they are used: the card's machine has no jax, and runs
# this file's card test alone.

torch.set_num_threads(1)

OUTCOMES = ("no candidate", "rejected", "closed")


def _mapper_np(cfg, outcome):
    from torch_keyframes import loop_state

    return loop_state(cfg, outcome)


def _cfg(outcome):
    from torch_keyframes import loop_tick_cfg

    return loop_tick_cfg(tiny_torch, outcome)


def _leaves(state):
    return [x.numpy() for x in graphs.flatten(state)]


@pytest.fixture(scope="module")
def states():
    cfg = _cfg("closed")
    return {o: _mapper_np(cfg, o) for o in OUTCOMES}


@pytest.mark.parametrize("outcome", OUTCOMES)
def test_gated_tick_equals_host_read_tick(states, outcome):
    """``loop_step`` with its gates in "select" mode, under a guard that
    makes every host read raise, equals the eager tick bit for bit."""
    from torch_keyframes import no_host_reads

    cfg = _cfg(outcome)
    read = tp.loop_step(cfg, convert.mapper_state(states[outcome], "cpu"))
    state = convert.mapper_state(states[outcome], "cpu")
    with graphs.cond_mode("select"), no_host_reads():
        gated = tp.loop_step(cfg, state)
    for i, (a, b) in enumerate(zip(_leaves(gated), _leaves(read))):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    assert int(read.loops_closed) == (outcome == "closed")
    assert int(read.loops.count) == (outcome == "closed")


def test_gn_gating_equals_early_exit(states):
    """``posegraph.solve`` and ``solve_batched`` with one gate per GN
    iteration ("select") equal an early-exit loop written out here, and the
    eager ``solve`` (a host read an iteration), bit for bit."""
    from torch_keyframes import no_host_reads

    cfg = _cfg("closed")
    m = tp.loop_step(cfg, convert.mapper_state(states["closed"], "cpu"))
    kf = convert.mapper_state(states["closed"], "cpu").kf
    assert int(m.loops.count) == 1
    K = kf.poses6.shape[0]
    node_ok = torch.arange(K) < kf.count
    X = tse3.pose6_to_mat(kf.poses6)
    done = torch.zeros((), dtype=torch.bool)
    iterations = 0
    for _ in range(cfg.posegraph.max_gn_iterations):
        conv, X_new = tpg.gn_step(cfg, X, kf.odom_z, m.loops, node_ok)
        X = torch.where(done, X, X_new)
        done = done | conv
        iterations += 1
        if bool(done):
            break
    want = torch.where(node_ok[:, None], tse3.mat_to_pose6(X), kf.poses6)
    args = (cfg, kf.poses6, kf.count, kf.odom_z, m.loops)
    eager = tpg.solve(*args)
    with graphs.cond_mode("select"), no_host_reads():
        gated = tpg.solve(*args)
    np.testing.assert_array_equal(eager.numpy(), want.numpy())
    np.testing.assert_array_equal(gated.numpy(), want.numpy())
    assert 1 < iterations < cfg.posegraph.max_gn_iterations

    # Two graphs, one inactive: it comes back bit-identical.
    two = [torch.stack([x, x]) for x in (kf.poses6, kf.count, kf.odom_z)]
    loops2 = tpg.LoopFactors(*(torch.stack([x, x]) for x in m.loops))
    active = torch.tensor([True, False])
    eager2 = tpg.solve_batched(cfg, *two, loops2, active)
    with graphs.cond_mode("select"), no_host_reads():
        gated2 = tpg.solve_batched(cfg, *two, loops2, active)
    np.testing.assert_array_equal(gated2.numpy(), eager2.numpy())
    np.testing.assert_array_equal(gated2[0].numpy(), want.numpy())
    np.testing.assert_array_equal(gated2[1].numpy(), kf.poses6.numpy())


def _rot_deg(a, b):
    R = np.einsum("...ji,...jk->...ik", a[..., :3, :3], b[..., :3, :3])
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(c))


def test_gated_loop_step_matches_jax(states):
    """The gated ``loop_step`` on the closing state against the JAX
    package's ``loop_step``: the same factor (i, j, count;
    Z within 5e-3 m / 0.05 deg) and re-solved keyframe poses, pose and
    correction within 5e-3 m / 0.05 deg (tests/test_torch_loop.py)."""
    import jax
    import jax.numpy as jnp
    from sc_lego_loam_tpu import pipeline as jp
    from sc_lego_loam_tpu.config import tiny_test_config
    from sc_lego_loam_tpu.utils import se3 as jse3
    from torch_keyframes import loop_cfg, short_loop

    cfg_j = short_loop(loop_cfg(tiny_test_config))
    st = states["closed"]
    jst = jax.tree.map(jnp.asarray, _jax_state(jp, st))
    mj = jax.tree.map(np.asarray, jp.loop_step(cfg_j, jst))
    with graphs.cond_mode("select"):
        mt = tp.loop_step(_cfg("closed"), convert.mapper_state(st, "cpu"))
    assert int(mt.loops_closed) == int(mj.loops_closed) == 1
    for name in ("i", "j", "count"):
        np.testing.assert_array_equal(getattr(mt.loops, name).numpy(),
                                      getattr(mj.loops, name))
    Zt, Zj = mt.loops.z.numpy(), mj.loops.z
    assert np.linalg.norm(Zt[:, :3, 3] - Zj[:, :3, 3], axis=1).max() < 5e-3
    assert _rot_deg(Zt, Zj).max() < 0.05
    k = int(mj.kf.count)
    Xt = tse3.pose6_to_mat(mt.kf.poses6).numpy()[:k]
    Xj = np.asarray(jse3.pose6_to_mat(jnp.asarray(mj.kf.poses6)))[:k]
    assert np.linalg.norm(Xt[:, :3, 3] - Xj[:, :3, 3], axis=1).max() < 5e-3
    assert _rot_deg(Xt, Xj).max() < 0.05
    assert np.abs(Xt - tse3.pose6_to_mat(torch.from_numpy(
        st.kf.poses6[:k])).numpy()).max() > 1e-4      # the re-solve moved
    for name in ("pose", "correction", "last_kf_pose"):
        a, b = getattr(mt, name).numpy(), getattr(mj, name)
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 5e-3, name
        assert _rot_deg(a, b) < 0.05, name


def _jax_state(jp, st):
    """The numpy state as the JAX package's ``MapperState``."""
    from sc_lego_loam_tpu import mapping as jmapping, posegraph as jpg
    from sc_lego_loam_tpu.models import scan_context as jsc

    def make(cls, ns):
        return cls(**{f: getattr(ns, f) for f in cls._fields})

    return jp.MapperState(
        kf=make(jmapping.KeyframeStore, st.kf),
        bank=make(jsc.DescriptorBank, st.bank),
        loops=make(jpg.LoopFactors, st.loops),
        **{f: getattr(st, f) for f in jp.MapperState._fields
           if f not in ("kf", "bank", "loops")})


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_graphed_tick_equals_eager_tick_on_the_card(card):
    """tests/test_torch_graphs.py's 12-scan drive (a loop closes at scan
    10) on the card with eager ticks; the mapper state going into each
    loop tick, copied, is then ticked by the eager ``loop_step`` and by one
    captured ``loop_step`` graph (conditional nodes; its first call is the
    warm-up, its second the capture): bit for bit, the closing tick
    included."""
    from sc_lego_loam_tpu_torch.utils import synthetic as tsyn
    from torch_mesh_ranks import ENGINE_SCANS, engine_cfg

    cfg = engine_cfg()
    scans, valids, _ = tsyn.make_sequence(
        cfg.lidar, ENGINE_SCANS, trajectory="straight", step=0.4,
        noise=0.01, seed=1)
    engine = tp.SlamEngine(cfg, eager=True)
    states = []
    tick = engine.loop_tick

    def recorded():
        states.append(tp._own(engine.m, engine.device))
        tick()

    engine.loop_tick = recorded
    for i in range(ENGINE_SCANS):
        engine.process_scan(scans[i], valids[i], t=i * 0.1)
    g = graphs.StepGraph(lambda m: (tp.loop_step(cfg, m),),
                         graphs.CudaCapture("cuda"), "loop_step")
    closed = 0
    for st in states:
        eager = tp.loop_step(cfg, tp._own(st, "cuda"))
        (graphed,) = g(tp._own(st, "cuda"))
        for a, b in zip(graphs.flatten(graphed), graphs.flatten(eager)):
            assert torch.equal(a, b)
        closed += int(eager.loops_closed) > int(st.loops_closed)
    assert closed >= 1 and len(states) >= 3
    assert g.replays == len(states) - 1 and g.census[0] > 0
