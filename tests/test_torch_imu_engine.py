"""The IMU in the loop, port against JAX package: one perception step and
one mapping step from the same mid-run state (``utils/convert.py`` carries
the IMU buffer across), and both engines over a 24-scan motion-skewed
figure-8 fed the same synthesized 100 Hz IMU stream, one
``push_imu_batch`` a scan (IMU de-skew, rotation prior and roll / pitch
blend all on)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu import pipeline as jp
from sc_lego_loam_tpu.config import ImuConfig, tiny_test_config
from sc_lego_loam_tpu.utils import synthetic
from sc_lego_loam_tpu_torch import pipeline as tp
from sc_lego_loam_tpu_torch.utils import convert, evaluate as teval

torch.set_num_threads(1)

N_SCANS = 24
SNAP = 6            # the third mapping tick (t = 0.6 s)


def T(x):
    return torch.from_numpy(np.array(x))


def _rot_deg(a, b):
    R = np.einsum("...ji,...jk->...ik", a[..., :3, :3], b[..., :3, :3])
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(c))


def _drive(engine, scans, valids, imu, after_push=None):
    """Every scan: the samples up to its end in one ``push_imu_batch``,
    ``after_push(i)``, then the scan."""
    times, rpy, acc, gyro = imu
    cursor = 0
    for i in range(len(scans)):
        end = int(np.searchsorted(times, (i + 1) * 0.1 + 1e-9, side="right"))
        if end > cursor:
            engine.push_imu_batch(times[cursor:end], rpy[cursor:end],
                                  acc[cursor:end], gyro[cursor:end])
            cursor = end
        if after_push is not None:
            after_push(i)
        engine.process_scan(scans[i], valids[i], t=i * 0.1)


@pytest.fixture(scope="module")
def runs():
    """Both engines over the drive; the JAX engine's state just before scan
    SNAP (its samples already pushed) is kept as numpy."""
    base = tiny_test_config()
    cfg = base.replace(imu=ImuConfig(enabled=True),
                       odom=dataclasses.replace(base.odom, deskew=True))
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, N_SCANS, trajectory="figure8", radius=12.0, loops=0.3,
        noise=0.01, seed=13, shuffle=False, skew=True)
    # gt[k] is the END pose of scan k, the pose at t = 0.1 (k + 1).
    imu = synthetic.make_imu_samples(gt, t0=0.1, period=0.1, rate_hz=100,
                                     seed=3)
    je = jp.SlamEngine(cfg)
    snap = {}

    def keep(i):
        if i == SNAP:
            snap.update(p=jax.tree.map(np.asarray, je.p),
                        m=jax.tree.map(np.asarray, je.m),
                        corr=np.asarray(je._correction))

    _drive(je, scans, valids, imu, keep)
    te = tp.SlamEngine(cfg, device="cpu")
    te.trace.on()               # its host spans are read by a test
    _drive(te, scans, valids, imu)
    return cfg, scans, valids, gt, je, te, snap


def _jax_perception(cfg, scans, valids, snap):
    return jp.perception_step(
        cfg, jax.tree.map(jnp.asarray, snap["p"]), jnp.asarray(snap["corr"]),
        jnp.asarray(scans[SNAP]), jnp.asarray(valids[SNAP]),
        jnp.float32(SNAP * 0.1))


def test_convert_carries_the_imu_buffer(runs):
    snap = runs[-1]
    pt = convert.perception_state(snap["p"], "cpu")
    # 100 Hz from t = 0.1 s up to scan SNAP's end.
    assert int(pt.imu.count) == int(snap["p"].imu.count) == 10 * SNAP + 1
    for name in pt.imu._fields:
        np.testing.assert_array_equal(getattr(pt.imu, name).numpy(),
                                      getattr(snap["p"].imu, name))


def test_imu_perception_step_from_shared_state(runs):
    """IMU de-skew, features, the IMU rotation prior and the odometry from
    the same state and buffer: the odometry pose within 2e-4 (the lidar-only
    step's tolerance, tests/test_torch_slice.py), the outlier mask equal and
    the de-skewed outlier points within 1e-4 m (fp32 interpolation weights
    on points up to ~50 m away)."""
    cfg, scans, valids, _, _, _, snap = runs
    pj, odom_j, out_j, outm_j, fused_j = _jax_perception(cfg, scans, valids,
                                                         snap)
    pt = convert.perception_state(snap["p"], "cpu")
    pt, odom_t, out_t, outm_t, fused_t = tp.perception_step(
        cfg, pt, T(snap["corr"]), T(scans[SNAP]), T(valids[SNAP]),
        torch.full((), SNAP * 0.1))
    np.testing.assert_allclose(odom_t.numpy(), np.asarray(odom_j), atol=2e-4)
    np.testing.assert_allclose(fused_t.numpy(), np.asarray(fused_j),
                               atol=2e-4)
    np.testing.assert_allclose(pt.odo.motion.numpy(),
                               np.asarray(pj.odo.motion), atol=2e-4)
    np.testing.assert_array_equal(outm_t.numpy(), np.asarray(outm_j))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4)
    # The IMU really was in the loop: the lidar-only step from the same
    # state lands somewhere else.
    off = cfg.replace(imu=ImuConfig(enabled=False))
    _, odom_off, *_ = tp.perception_step(
        off, convert.perception_state(snap["p"], "cpu"), T(snap["corr"]),
        T(scans[SNAP]), T(valids[SNAP]), torch.full((), SNAP * 0.1))
    assert np.abs(odom_off.numpy() - odom_t.numpy()).max() > 1e-3


def test_imu_mapping_step_from_shared_state(runs):
    """Scan-to-map and the roll / pitch blend from the same state, inputs
    and buffer: 0.05 m and 0.5 deg, the spread of the lidar-only step
    (tests/test_torch_slice.py), for the pose and for the correction."""
    cfg, scans, valids, _, _, _, snap = runs
    pj, odom, out_pts, out_mask, _ = _jax_perception(cfg, scans, valids, snap)
    args = (pj.odo.corner_last.xyz, pj.odo.corner_last.mask,
            pj.odo.surf_last.xyz, pj.odo.surf_last.mask, out_pts, out_mask,
            odom, jnp.asarray(scans[SNAP]), jnp.asarray(valids[SNAP]),
            jnp.float32(SNAP * 0.1))
    targs = [T(a) for a in args]
    mj = jp.mapping_step(cfg, jax.tree.map(jnp.asarray, snap["m"]), *args,
                         pj.imu)
    mt = tp.mapping_step(cfg, convert.mapper_state(snap["m"], "cpu"), *targs,
                         convert.perception_state(snap["p"], "cpu").imu)
    pose_j, pose_t = np.asarray(mj.pose), mt.pose.numpy()
    assert np.linalg.norm(pose_t[:3, 3] - pose_j[:3, 3]) < 0.05
    assert _rot_deg(pose_t, pose_j) < 0.5
    assert int(mt.kf.count) == int(mj.kf.count)
    corr_j, corr_t = np.asarray(mj.correction), mt.correction.numpy()
    assert np.linalg.norm(corr_t[:3, 3] - corr_j[:3, 3]) < 0.05
    assert _rot_deg(corr_t, corr_j) < 0.5


def test_imu_engines_track_alike(runs):
    """Both engines over the drive.  Before the second mapping tick (pure
    odometry on the IMU-de-skewed clouds) the poses agree to 1 mm and 0.05
    deg; up to the third, to 0.05 m and 1 deg (one scan-to-map solve
    against a one-keyframe map: the JAX package's own jitted and eager
    mapping steps differ by 0.34 deg, tests/test_torch_slice.py).  After it
    each engine matches against its own map, and on this fixture (a 16 x
    128 sensor, skewed scans) both end ~0.35 m RMS from the truth: the run
    is held to one ATE band and the engines to be no farther from each
    other than twice the larger ATE."""
    cfg, _, _, gt, je, te, _ = runs
    ej, et = je.trajectory_array(), te.trajectory_array()
    assert et.shape == ej.shape == (N_SCANS, 4, 4)
    assert np.isfinite(et).all()
    dt = np.linalg.norm(et[:, :3, 3] - ej[:, :3, 3], axis=1)
    dr = _rot_deg(et, ej)
    assert dt[:3].max() < 1e-3 and dr[:3].max() < 0.05, (dt, dr)
    assert dt[:SNAP].max() < 0.05 and dr[:SNAP].max() < 1.0, (dt, dr)
    ate_t, ate_j = teval.ate_rmse(et, gt), teval.ate_rmse(ej, gt)
    assert ate_t < max(1.25 * ate_j, 0.25), (ate_t, ate_j)
    assert dt.max() < 2.0 * max(ate_t, ate_j) and dr.max() < 3.0, (dt, dr)
    assert int(te.m.kf.count) == int(je.map.kf.count)
    assert int(te.p.imu.count) == int(je.p.imu.count)
    assert set(te.trace.summary()) >= {"perception_step", "mapping_step"}
