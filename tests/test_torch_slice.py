"""The port's first slice as a whole against the JAX package, loop closure off:
one perception step and one mapping step from the same mid-run state
(brought across by ``utils/convert.py``), both engines over the 10-scan
straight fixture of tests/test_pipeline.py, and the port's independence
from jax."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu import pipeline as jp
from sc_lego_loam_tpu.config import ImuConfig, tiny_test_config
from sc_lego_loam_tpu.utils import evaluate as jeval, synthetic
from sc_lego_loam_tpu_torch import pipeline as tp
from sc_lego_loam_tpu_torch.utils import convert, evaluate as teval

torch.set_num_threads(1)

N_SCANS = 10
SNAP = 3            # the second mapping tick (t = 0.3 s)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(x):
    return torch.from_numpy(np.array(x))


def _loop_off(cfg):
    return cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=False))


def _rot_deg(a, b):
    R = np.einsum("...ji,...jk->...ik", a[..., :3, :3], b[..., :3, :3])
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(c))


@pytest.fixture(scope="module")
def runs():
    """Both engines over the fixture; the JAX engine's state just before
    scan SNAP is kept as numpy."""
    cfg = _loop_off(tiny_test_config())
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, N_SCANS, trajectory="straight", step=0.4, noise=0.01,
        seed=7)
    je = jp.SlamEngine(cfg)
    snap = None
    for i in range(N_SCANS):
        if i == SNAP:
            snap = (jax.tree.map(np.asarray, je.p),
                    jax.tree.map(np.asarray, je.m),
                    np.asarray(je._correction))
        je.process_scan(scans[i], valids[i], t=i * 0.1)
    te = tp.SlamEngine(cfg, device="cpu")
    for i in range(N_SCANS):
        te.process_scan(scans[i], valids[i], t=i * 0.1)
    return cfg, scans, valids, gt, je, te, snap


def _jax_perception(cfg, scans, valids, snap):
    p_np, _, corr = snap
    return jp.perception_step(cfg, jax.tree.map(jnp.asarray, p_np),
                              jnp.asarray(corr), jnp.asarray(scans[SNAP]),
                              jnp.asarray(valids[SNAP]),
                              jnp.float32(SNAP * 0.1))


def test_perception_step_from_shared_state(runs):
    """Front end, de-skew, features and odometry from the same state: the
    odometry pose within 2e-4 (fp32 LM sums in another order), the
    outlier list exactly."""
    cfg, scans, valids, _, _, _, snap = runs
    pj, odom_j, out_j, outm_j, fused_j = _jax_perception(cfg, scans, valids,
                                                         snap)
    pt = convert.perception_state(snap[0], "cpu")
    pt, odom_t, out_t, outm_t, fused_t = tp.perception_step(
        cfg, pt, T(snap[2]), T(scans[SNAP]), T(valids[SNAP]),
        torch.full((), SNAP * 0.1))
    np.testing.assert_allclose(odom_t.numpy(), np.asarray(odom_j), atol=2e-4)
    np.testing.assert_allclose(fused_t.numpy(), np.asarray(fused_j),
                               atol=2e-4)
    np.testing.assert_array_equal(outm_t.numpy(), np.asarray(outm_j))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert int(pt.scan_i) == SNAP + 1
    np.testing.assert_allclose(pt.traj[SNAP].numpy(), np.asarray(fused_j),
                               atol=2e-4)


def test_mapping_step_from_shared_state(runs):
    """Submap, scan downsample, scan-to-map LM and the guarded keyframe +
    descriptor insert from the same state and inputs.  The pose agrees to
    0.05 m and 0.5 deg: the plane fits solve fp32 normal equations whose
    ulp-level differences move normals by ~1e-2, which the JAX package's
    own jitted and eager runs of this step show too (0.34 deg apart)."""
    cfg, scans, valids, _, _, _, snap = runs
    pj, odom, out_pts, out_mask, _ = _jax_perception(cfg, scans, valids, snap)
    args = (pj.odo.corner_last.xyz, pj.odo.corner_last.mask,
            pj.odo.surf_last.xyz, pj.odo.surf_last.mask, out_pts, out_mask,
            odom, jnp.asarray(scans[SNAP]), jnp.asarray(valids[SNAP]),
            jnp.float32(SNAP * 0.1))
    targs = [T(a) for a in args]
    mt = convert.mapper_state(snap[1], "cpu")
    mj = jp.mapping_step(cfg, jax.tree.map(jnp.asarray, snap[1]), *args,
                         pj.imu)
    mt = tp.mapping_step(cfg, mt, *targs)
    pose_j, pose_t = np.asarray(mj.pose), mt.pose.numpy()
    assert np.linalg.norm(pose_t[:3, 3] - pose_j[:3, 3]) < 0.05
    assert _rot_deg(pose_t, pose_j) < 0.5
    n = int(mj.kf.count)
    assert int(mt.kf.count) == n == 2 and int(mt.bank.count) == n
    np.testing.assert_array_equal(mt.kf.surf_mask[:n].numpy(),
                                  np.asarray(mj.kf.surf_mask[:n]))
    np.testing.assert_array_equal(mt.kf.surf[:n].numpy(),
                                  np.asarray(mj.kf.surf[:n]))
    # Scan Context: the same scatter-max, exactly.
    np.testing.assert_array_equal(mt.bank.desc[:n].numpy(),
                                  np.asarray(mj.bank.desc[:n]))
    np.testing.assert_allclose(mt.correction.numpy(),
                               np.asarray(mj.correction), atol=0.02)


def test_engines_track_alike(runs):
    """Both engines over the fixture.  Up to the second mapping tick the
    poses agree to 0.05 m and 0.5 deg.  Later ticks solve against maps
    that already differ by that much, and the plane-fit sensitivity above
    compounds: the JAX package's own jitted and eager engines end 0.19 m
    and 1.98 deg apart on this fixture, so the whole run is held to that
    spread and to the reference's ATE bound (tests/test_pipeline.py)."""
    cfg, _, _, gt, je, te, _ = runs
    ej, et = je.trajectory_array(), te.trajectory_array()
    assert et.shape == ej.shape == (N_SCANS, 4, 4)
    assert np.isfinite(et).all()
    dt = np.linalg.norm(et[:, :3, 3] - ej[:, :3, 3], axis=1)
    dr = _rot_deg(et, ej)
    early = slice(0, SNAP + 3)
    assert dt[early].max() < 0.05 and dr[early].max() < 0.5, (dt, dr)
    assert dt.max() < 0.2 and dr.max() < 2.0, (dt, dr)
    assert teval.ate_rmse(et, gt) < 0.25
    assert jeval.ate_rmse(ej, gt) < 0.25
    assert int(te.m.kf.count) == int(je.map.kf.count) >= 2
    assert int(te.m.bank.count) == int(te.m.kf.count)
    np.testing.assert_allclose(te.trajectory_times(), je.trajectory_times())
    # The numpy Umeyama ATE agrees with the JAX package's.
    assert abs(teval.ate_rmse(et, gt) - jeval.ate_rmse(et, gt)) < 1e-4


def test_engine_refuses_unported_paths():
    """No configuration that the JAX package's ``SlamEngine(cfg)`` accepts
    raises ``NotImplementedError`` any more: the IMU and the two-stage
    odometry run.  What is refused is the default device without a card."""
    cfg = tiny_test_config()                 # loop closure on by default
    n = cfg.lidar.max_points
    two_stage = cfg.replace(odom=dataclasses.replace(cfg.odom,
                                                     joint_6dof=False))
    for c in (cfg, cfg.replace(imu=ImuConfig(enabled=True)), two_stage):
        engine = tp.SlamEngine(c, device="cpu")
        if c.imu.enabled:
            engine.push_imu(0.0, np.zeros(3), np.float32([0, 0, 9.81]),
                            np.zeros(3))
        pose = engine.process_scan(np.zeros((n, 3), np.float32),
                                   np.zeros(n, bool), t=0.0)
        assert torch.isfinite(pose).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.SlamEngine(cfg)               # device defaults to "cuda"
    with pytest.raises(AssertionError, match="at most 32"):
        tp.SlamEngine(cfg, device="cpu").push_imu_batch(
            np.zeros(33), np.zeros((33, 3)), np.zeros((33, 3)),
            np.zeros((33, 3)))


def test_port_imports_no_jax():
    """In a fresh interpreter: import every module of the port, build the
    engine with loop closure and IMU on, feed it IMU samples and a scan,
    gather a checkpoint, build the native loader.  Neither jax nor the
    JAX package (nor a submodule of either) gets imported."""
    code = """
import importlib, pkgutil, sys
import numpy as np
import sc_lego_loam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
assert len(names) >= 61, names
for name in ('imu', 'runner', 'utils.profiling', 'utils.mulran',
             'utils.native_io', 'utils.export', 'tools.run_synthetic',
             'tools.run_mulran', 'tools.bench', 'tools.profile_stages',
             'tools.run_capacity', 'tools.profile_iters',
             'tools.profile_odo', 'tools.profile_s2m', 'tools.tune_research',
             'tools.diag_loops', 'tools.diag_real', 'tools.debug_fig8',
             'tools.diag_tiny', 'tools.profile_micro',
             'tools.profile_latency', 'tools.profile_engine2'):
    assert 'sc_lego_loam_tpu_torch.' + name in names, name
from sc_lego_loam_tpu_torch.config import ImuConfig, tiny_test_config
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.utils import export, native_io
cfg = tiny_test_config().replace(imu=ImuConfig(enabled=True))
assert cfg.loop.enabled
engine = SlamEngine(cfg, device='cpu')
n = cfg.lidar.max_points
engine.push_imu_batch(np.float32([0.0, 0.01]), np.zeros((2, 3)),
                      np.zeros((2, 3)), np.zeros((2, 3)))
engine.process_scan(np.zeros((n, 3), np.float32), np.zeros(n, bool), t=0.0)
export.checkpoint_arrays(engine)
native_io.available()
bad = sorted(m for m in sys.modules
             if m in ('jax', 'jaxlib', 'sc_lego_loam_tpu')
             or m.startswith(('jax.', 'jaxlib.', 'sc_lego_loam_tpu.')))
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env)
