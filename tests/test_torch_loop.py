"""Loop closure of the port against the JAX package's from ONE shared
mid-run state: the JAX engine drives the revisiting figure-8 of
tests/test_loop_e2e.py, every state it hands to ``loop_step`` is kept as
numpy, and ``utils/convert`` carries it into the port.  Detection,
``loop.verify`` and ``pipeline.loop_step`` then run in both from the same
numbers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu import loop as jloop, pipeline as jp
from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu.models import scan_context as jsc
from sc_lego_loam_tpu.utils import se3 as jse3, synthetic
from sc_lego_loam_tpu_torch import loop as tloop, pipeline as tp
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch
from sc_lego_loam_tpu_torch.models import scan_context as tsc
from sc_lego_loam_tpu_torch.utils import convert, se3 as tse3

torch.set_num_threads(1)

N_PATH = 80          # the fixture's path; the drive stops after N_RUN scans
N_RUN = 48


def T(x):
    return torch.from_numpy(np.array(x))


def _cfg(base):
    """tests/test_loop_e2e.py's thresholds, and the relaxed graph weights of
    tests/test_posegraph.py: with the reference's odometry variances a
    dozen keyframes are so stiff that a re-solve moves nothing, and the
    comparison of the re-solved poses would be empty."""
    cfg = base()
    return cfg.replace(
        sc=dataclasses.replace(cfg.sc, exclude_recent=10),
        loop=dataclasses.replace(cfg.loop, check_every_ticks=2,
                                 rs_time_gap=4.0, rs_search_radius=4.0,
                                 loop_noise_var=1e-2),
        posegraph=dataclasses.replace(cfg.posegraph, odom_var=(1e-2,) * 6))


def _rot_deg(a, b):
    R = np.einsum("...ji,...jk->...ik", a[..., :3, :3], b[..., :3, :3])
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(c))


def _leaves(state):
    return jax.tree.leaves(jax.tree.map(np.asarray, state))


@pytest.fixture(scope="module")
def drive():
    """The JAX engine over the first N_RUN scans; ``ticks`` holds, for every
    loop tick, the mapper state going in (numpy) and whether it closed."""
    cfg = _cfg(tiny_test_config)
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, N_PATH, trajectory="figure8", radius=12.0, loops=1.05,
        noise=0.01, seed=3, shuffle=True)
    ticks = []
    real_loop_step = jp.loop_step

    def recording_loop_step(config, mst):
        before = jax.tree.map(np.array, mst)     # the step donates ``mst``
        out = real_loop_step(config, mst)
        ticks.append((before, int(out.loops_closed) > int(before.loops_closed)))
        return out

    engine = jp.SlamEngine(cfg)
    jp.loop_step = recording_loop_step
    try:
        for i in range(N_RUN):
            engine.process_scan(scans[i], valids[i], t=i * 0.1)
    finally:
        jp.loop_step = real_loop_step
    closing = [s for s, closed in ticks if closed]
    assert closing, "the JAX engine closed no loop on the fixture"
    return cfg, _cfg(tiny_torch), engine, ticks, closing[0], gt


def _candidates_jax(cfg, st):
    kf = jax.tree.map(jnp.asarray, st.kf)
    bank = jax.tree.map(jnp.asarray, st.bank)
    cur = jnp.maximum(kf.count - 1, 0)
    sc_idx, sc_dist, sc_yaw = jsc.detect(cfg, bank, bank.desc[cur])
    rs_idx = jloop.detect_radius(cfg, kf, cur)
    return kf, cur, sc_idx, sc_dist, sc_yaw, rs_idx


def _candidates_torch(cfg, st):
    m = convert.mapper_state(st, "cpu")
    cur = torch.clamp(m.kf.count - 1, min=0)
    sc_idx, sc_dist, sc_yaw = tsc.detect(cfg, m.bank, m.bank.desc[int(cur)])
    rs_idx = tloop.detect_radius(cfg, m.kf, cur)
    return m, cur, sc_idx, sc_dist, sc_yaw, rs_idx


def test_detectors_agree_on_every_tick(drive):
    """Scan Context and radius detection from every recorded state: the
    same candidate (or the same -1), the same shift."""
    cj, ct, _, ticks, _, _ = drive
    seen = set()
    for st, _ in ticks:
        _, _, sj, dj, yj, rj = _candidates_jax(cj, st)
        _, _, s_t, d_t, y_t, r_t = _candidates_torch(ct, st)
        assert int(s_t) == int(sj) and int(r_t) == int(rj)
        assert float(d_t) == pytest.approx(float(dj), abs=1e-5)
        assert float(y_t) == pytest.approx(float(yj), abs=1e-6)
        assert r_t.dtype == torch.int64 and r_t.shape == ()
        seen.update([int(sj) >= 0, int(rj) >= 0])
    assert seen == {False, True}       # ticks with and without a candidate


def test_history_submap_and_keyframe_cloud_match(drive):
    """The ICP's two clouds from the shared state: the voxel decimation
    keeps the lowest-index point of each bucket in both, so the clouds are
    equal up to the fp32 rounding of the pose transform (1e-5 m)."""
    cj, ct, _, _, st, _ = drive
    kf_j, cur_j, *_ = _candidates_jax(cj, st)
    m, cur_t, *_ = _candidates_torch(ct, st)
    for center in (0, 3, int(cur_j)):
        pj, mj = jloop.history_submap(cj, kf_j, jnp.int32(center))
        pt, mt = tloop.history_submap(ct, m.kf, torch.tensor(center))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    place = np.asarray(jse3.pose6_to_mat(kf_j.poses6[2]))
    pj, mj = jloop.keyframe_cloud(cj, kf_j, cur_j, jnp.asarray(place))
    pt, mt = tloop.keyframe_cloud(ct, m.kf, cur_t, T(place))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)


def test_verify_from_shared_state(drive):
    """``loop.verify`` on the closing tick's state, for each detector that
    fired there: the same accept flag, Z within 5e-3 m and 0.05 deg,
    fitness within 1e-3 (ICP tolerances, tests/test_torch_icp.py; no
    source point of this fixture is beyond the 8 m search range)."""
    cj, ct, _, _, st, _ = drive
    kf_j, cur_j, sj, _, yj, rj = _candidates_jax(cj, st)
    m, cur_t, s_t, _, y_t, r_t = _candidates_torch(ct, st)
    ran = 0
    if int(sj) >= 0:
        place = jse3.pose6_to_mat(kf_j.poses6[sj])
        Zj, fj, okj = jloop.verify(cj, kf_j, cur_j, sj, place, yaw_init=yj)
        Zt, ft, okt = tloop.verify(ct, m.kf, cur_t, s_t, T(place),
                                   yaw_init=y_t)
        ran += 1
        assert bool(okt) == bool(okj)
        assert float(ft) == pytest.approx(float(fj), abs=1e-3)
        assert np.linalg.norm(Zt.numpy()[:3, 3] - np.asarray(Zj)[:3, 3]) < 5e-3
        assert _rot_deg(Zt.numpy(), np.asarray(Zj)) < 0.05
    if int(rj) >= 0:
        place = jse3.pose6_to_mat(kf_j.poses6[cur_j])
        Zj, fj, okj = jloop.verify(cj, kf_j, cur_j, rj, place)
        Zt, ft, okt = tloop.verify(ct, m.kf, cur_t, r_t, T(place))
        ran += 1
        assert bool(okt) == bool(okj)
        assert float(ft) == pytest.approx(float(fj), abs=1e-3)
        assert np.linalg.norm(Zt.numpy()[:3, 3] - np.asarray(Zj)[:3, 3]) < 5e-3
        assert _rot_deg(Zt.numpy(), np.asarray(Zj)) < 0.05
    assert ran >= 1


def test_loop_step_from_shared_state(drive):
    """``pipeline.loop_step`` on the closing tick's state: both close, add
    the same factors (i, j) in the same slots with Z within 5e-3 m /
    0.05 deg, and re-solve the keyframe poses to within 5e-3 m / 0.05 deg
    of each other; pose, correction and last_kf_pose follow."""
    cj, ct, _, _, st, _ = drive
    mj = jp.loop_step(cj, jax.tree.map(jnp.asarray, st))
    mt = tp.loop_step(ct, convert.mapper_state(st, "cpu"))
    assert int(mt.loops_closed) == int(mj.loops_closed) == \
        int(st.loops_closed) + 1
    n = int(mj.loops.count)
    assert int(mt.loops.count) == n > int(st.loops.count)
    np.testing.assert_array_equal(mt.loops.i.numpy(), np.asarray(mj.loops.i))
    np.testing.assert_array_equal(mt.loops.j.numpy(), np.asarray(mj.loops.j))
    Zt, Zj = mt.loops.z.numpy(), np.asarray(mj.loops.z)
    assert np.linalg.norm(Zt[:, :3, 3] - Zj[:, :3, 3], axis=1).max() < 5e-3
    assert _rot_deg(Zt, Zj).max() < 0.05
    k = int(mj.kf.count)
    Xt = tse3.pose6_to_mat(mt.kf.poses6).numpy()
    Xj = np.asarray(jse3.pose6_to_mat(mj.kf.poses6))
    assert np.linalg.norm(Xt[:k, :3, 3] - Xj[:k, :3, 3], axis=1).max() < 5e-3
    assert _rot_deg(Xt[:k], Xj[:k]).max() < 0.05
    np.testing.assert_array_equal(mt.kf.poses6.numpy()[k:], st.kf.poses6[k:])
    # The re-solve moved something, and the engine's pose follows it.
    X0 = np.asarray(jse3.pose6_to_mat(jnp.asarray(st.kf.poses6)))
    assert np.abs(Xt[:k] - X0[:k]).max() > 1e-4
    for name in ("pose", "correction", "last_kf_pose"):
        a, b = getattr(mt, name).numpy(), np.asarray(getattr(mj, name))
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 5e-3, name
        assert _rot_deg(a, b) < 0.05, name
    np.testing.assert_array_equal(mt.pose.numpy(), Xt[k - 1])
    np.testing.assert_array_equal(mt.last_kf_odom.numpy(), st.last_kf_odom)
    # The banks the tick only reads are the very tensors it was given.
    np.testing.assert_array_equal(mt.kf.surf.numpy(), st.kf.surf)
    np.testing.assert_array_equal(mt.bank.desc.numpy(), st.bank.desc)


def test_untaken_tick_leaves_state_bit_identical(drive):
    """A tick without a candidate (the first recorded one), in both: every
    leaf of the state comes back bit for bit."""
    cj, ct, _, ticks, _, _ = drive
    st, closed = ticks[0]
    assert not closed
    mt = tp.loop_step(ct, convert.mapper_state(st, "cpu"))
    mj = jp.loop_step(cj, jax.tree.map(jnp.asarray, st))
    for a, b, c in zip(_leaves(jax.tree.map(lambda x: x.numpy(), mt)),
                       _leaves(st), _leaves(mj)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)


def test_rejected_factor_leaves_bank_bit_identical(drive):
    """The closing tick's state under a fitness gate nothing can pass: the
    ICP runs, ``add_loop`` is computed and not taken.  Loop bank, poses6,
    pose, correction, last_kf_pose and loops_closed are untouched."""
    _, ct, _, _, st, _ = drive
    strict = ct.replace(loop=dataclasses.replace(ct.loop,
                                                 fitness_threshold=-1.0))
    m0 = convert.mapper_state(st, "cpu")
    kf, loops, closed = tloop.device_tick(
        strict, m0.kf, m0.bank, m0.loops,
        m0.bank.desc[int(m0.kf.count) - 1])
    assert not bool(closed)
    for a, b in zip(loops, st.loops):
        np.testing.assert_array_equal(a.numpy(), b)
    assert kf.poses6 is m0.kf.poses6
    mt = tp.loop_step(strict, convert.mapper_state(st, "cpu"))
    for a, b in zip(_leaves(jax.tree.map(lambda x: x.numpy(), mt)),
                    _leaves(st)):
        np.testing.assert_array_equal(a, b)


def test_trajectory_retro_correction_after_closure(drive):
    """The JAX engine's end state (a loop closed on the way) carried into a
    port engine: ``trajectory_array`` re-expresses every scan through the
    corrected keyframe graph exactly as the JAX package does (1e-5), and
    the as-published stream is the stored one, which the closure did move
    away from the corrected path."""
    cj, ct, je, _, _, gt = drive
    te = tp.SlamEngine(ct, device="cpu")
    te.p = convert.perception_state(jax.tree.map(np.asarray, je.p), "cpu")
    te.m = convert.mapper_state(jax.tree.map(np.asarray, je.m), "cpu")
    assert int(te.loops_closed) == int(je.loops_closed) >= 1
    assert int(te.loops.count) == int(je.loops.count)
    ej, et = je.trajectory_array(), te.trajectory_array()
    assert et.shape == (N_RUN, 4, 4)
    np.testing.assert_allclose(et, ej, atol=1e-5)
    raw_j = je.trajectory_array(retro_correct=False)
    raw_t = te.trajectory_array(retro_correct=False)
    np.testing.assert_array_equal(raw_t, raw_j)
    assert np.abs(raw_t - et).max() > 1e-3
