"""Checkpoint, resume and export of the port (``utils/export.py``) against
the JAX package's: round trip bit for bit, files that cross between the
packages in both directions, a resumed engine that goes on as the saved one
would have, and PLY / TUM bytes equal to the JAX package's for the same
arrays."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu import pipeline as jp
from sc_lego_loam_tpu.config import ImuConfig, tiny_test_config
from sc_lego_loam_tpu.utils import export as jexport, synthetic
from sc_lego_loam_tpu_torch import pipeline as tp
from sc_lego_loam_tpu_torch.utils import convert, export as texport

torch.set_num_threads(1)

N_SAVED = 7          # scans before the checkpoint (3 keyframes)
N_MORE = 4           # scans after it: a mapping tick and a keyframe more
# The JAX package's NPZ keys (sc_lego_loam_tpu/utils/export.py).
JAX_KEYS = {"poses6", "times", "corner", "corner_mask", "surf", "surf_mask",
            "outlier", "outlier_mask", "odom_z", "kf_count", "sc_desc",
            "sc_ringkey", "sc_count", "loop_i", "loop_j", "loop_z",
            "loop_count", "correction", "pose"}
ADDED_KEYS = {"odom_pose", "last_kf_pose", "last_kf_odom", "loops_closed",
              "kf_dropped"}


def _leaves(state):
    return dict(texport.state_leaves(state))


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        assert torch.equal(la[name], lb[name]), name


def _feed(engine, scans, valids, imu, lo, hi):
    times, rpy, acc, gyro = imu
    for i in range(lo, hi):
        a = int(np.searchsorted(times, i * 0.1 + 1e-9, side="right"))
        b = int(np.searchsorted(times, (i + 1) * 0.1 + 1e-9, side="right"))
        if b > a:
            engine.push_imu_batch(times[a:b], rpy[a:b], acc[a:b], gyro[a:b])
        engine.process_scan(scans[i], valids[i], t=i * 0.1)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The port's engine, IMU on, checkpointed after N_SAVED scans."""
    cfg = tiny_test_config().replace(imu=ImuConfig(enabled=True,
                                                   deskew=False))
    n = N_SAVED + N_MORE
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, n, trajectory="straight", step=0.4, noise=0.01, seed=7)
    imu = synthetic.make_imu_samples(gt, t0=0.0, period=0.1, rate_hz=100,
                                     seed=2)
    engine = tp.SlamEngine(cfg, device="cpu")
    _feed(engine, scans, valids, imu, 0, N_SAVED)
    path = str(tmp_path_factory.mktemp("ckpt") / "engine.npz")
    texport.save_checkpoint(path, engine)
    return cfg, scans, valids, imu, engine, path


def test_checkpoint_keys(saved):
    """Every key of the JAX package's file under the same name, shape and
    dtype as that package would write it, and the keys it lacks."""
    cfg, *_, engine, path = saved
    with np.load(path) as z:
        keys = set(z.files)
        assert JAX_KEYS | ADDED_KEYS <= keys
        je = jp.SlamEngine(cfg)
        jkf = je.map.kf
        for key, ref in (("poses6", jkf.poses6), ("corner", jkf.corner),
                         ("surf_mask", jkf.surf_mask),
                         ("odom_z", jkf.odom_z), ("kf_count", jkf.count),
                         ("sc_desc", je.bank.desc), ("loop_z", je.loops.z),
                         ("loop_count", je.loops.count),
                         ("odom_pose", jkf.odom_pose)):
            assert z[key].shape == ref.shape, key
            assert z[key].dtype == ref.dtype, key
        assert int(z["kf_count"]) == int(engine.m.kf.count) == 3
    rest = keys - JAX_KEYS - ADDED_KEYS
    assert all(k.startswith(("p.", "host.")) for k in rest), rest
    assert {"p.odo.pose", "p.imu.shift", "p.traj", "p.scan_i",
            "host.map_ticks", "host.last_map_time"} <= rest


def test_round_trip_is_bit_equal(saved):
    cfg, *_, engine, path = saved
    fresh = tp.SlamEngine(cfg, device="cpu")
    assert texport.load_checkpoint(path, fresh) is fresh
    _assert_states_equal(fresh.m, engine.m)
    _assert_states_equal(fresh.p, engine.p)
    assert (fresh.map_ticks, fresh.loop_ticks, fresh.last_map_time,
            fresh._scans_fed) == (engine.map_ticks, engine.loop_ticks,
                                  engine.last_map_time, engine._scans_fed)
    # Its own tensors, not views of the file's arrays or of the engine's.
    fresh.m.kf.poses6[0] += 1.0
    assert not torch.equal(fresh.m.kf.poses6, engine.m.kf.poses6)


def test_resume_keeps_the_trajectory_and_goes_on_alike(saved):
    """A fresh engine loaded from the file has the saved run's
    ``trajectory_array()`` (retro-corrected through the keyframes' odometry
    anchors, which the JAX package's file lacks), and fed the next scans it
    goes on exactly as the saved engine does."""
    cfg, scans, valids, imu, engine, path = saved
    resumed = texport.load_checkpoint(path, tp.SlamEngine(cfg, device="cpu"))
    before = engine.trajectory_array()
    assert before.shape == (N_SAVED, 4, 4)
    np.testing.assert_array_equal(resumed.trajectory_array(), before)
    np.testing.assert_array_equal(resumed.trajectory_array(False),
                                  engine.trajectory_array(False))
    # The original goes on from a copy of its own state (the fixture's
    # engine stays as saved for the other tests).
    original = tp.SlamEngine(cfg, device="cpu")
    original.p, original.m = tp._own(engine.p, "cpu"), tp._own(engine.m, "cpu")
    for name in texport._HOST_FIELDS:
        setattr(original, name, getattr(engine, name))
    n = N_SAVED + N_MORE
    _feed(original, scans, valids, imu, N_SAVED, n)
    _feed(resumed, scans, valids, imu, N_SAVED, n)
    assert int(resumed.m.kf.count) == int(original.m.kf.count) > 3
    np.testing.assert_array_equal(resumed.trajectory_array(),
                                  original.trajectory_array())
    assert resumed.trajectory_array().shape == (n, 4, 4)
    # Without the anchors every old scan would sit at its raw fused pose
    # times identity: the retro-corrected history is not the fused stream.
    assert not np.array_equal(resumed.trajectory_array(),
                              resumed.trajectory_array(False))


def test_jax_checkpoint_loads_into_the_port(saved, tmp_path):
    """An NPZ written by the JAX package: every key it has arrives bit for
    bit, every key it lacks keeps the fresh engine's value."""
    cfg, scans, valids, *_ = saved
    je = jp.SlamEngine(cfg)
    for i in range(4):
        je.process_scan(scans[i], valids[i], t=i * 0.1)
    path = str(tmp_path / "jax.npz")
    jexport.save_checkpoint(path, je)
    te = texport.load_checkpoint(path, tp.SlamEngine(cfg, device="cpu"))
    want = convert.mapper_state(jax.tree.map(np.asarray, je.m), "cpu")
    fresh = tp.SlamEngine(cfg, device="cpu")
    lacking = ("kf.odom_pose", "last_kf_pose", "last_kf_odom",
               "loops_closed", "kf_dropped")
    got, ref, new = _leaves(te.m), _leaves(want), _leaves(fresh.m)
    for name in got:
        assert torch.equal(got[name], new[name] if name in lacking
                           else ref[name]), name
    assert int(te.m.kf.count) == 2
    _assert_states_equal(te.p, fresh.p)
    assert te.map_ticks == 0


def test_port_checkpoint_loads_into_the_jax_package(saved):
    cfg, *_, engine, path = saved
    je = jexport.load_checkpoint(path, jp.SlamEngine(cfg))
    kf = je.map.kf
    for name in ("poses6", "times", "corner", "corner_mask", "surf",
                 "surf_mask", "outlier", "outlier_mask", "odom_z", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(kf, name)),
                                      getattr(engine.m.kf, name).numpy())
    for name in ("desc", "ringkey", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(je.bank, name)),
                                      getattr(engine.m.bank, name).numpy())
    for name in ("i", "j", "z", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(je.loops, name)),
                                      getattr(engine.m.loops, name).numpy())
    np.testing.assert_array_equal(np.asarray(je.map.correction),
                                  engine.m.correction.numpy())
    np.testing.assert_array_equal(np.asarray(je.map.pose),
                                  engine.m.pose.numpy())
    # ... and that engine runs on from it.
    n = cfg.lidar.max_points
    pose = je.process_scan(np.zeros((n, 3), np.float32), np.zeros(n, bool),
                           t=1.0)
    assert np.isfinite(np.asarray(pose)).all()


def test_checkpoint_of_another_capacity_is_refused(saved):
    cfg, *_, path = saved
    small = cfg.replace(cap=dataclasses.replace(
        cfg.cap, max_keyframes=cfg.cap.max_keyframes // 2))
    with pytest.raises(ValueError, match="shape"):
        texport.load_checkpoint(path, tp.SlamEngine(small, device="cpu"))


def test_state_views_and_setters(saved):
    """``engine.map`` / ``.bank`` / ``.odo`` / ``.loops``: the views the
    export code reads, and setters that copy onto the engine's device."""
    cfg, *_, engine, _ = saved
    fresh = tp.SlamEngine(cfg, device="cpu")
    fresh.map, fresh.bank = engine.map, engine.bank
    fresh.odo, fresh.loops = engine.odo, engine.loops
    assert torch.equal(fresh.m.kf.corner, engine.m.kf.corner)
    assert torch.equal(fresh.m.correction, engine.m.correction)
    assert torch.equal(fresh.m.bank.desc, engine.m.bank.desc)
    assert torch.equal(fresh.p.odo.pose, engine.p.odo.pose)
    assert torch.equal(fresh.loops.z, engine.loops.z)
    assert fresh.m.kf.corner.data_ptr() != engine.m.kf.corner.data_ptr()
    assert fresh.map.last_kf_pose is fresh.m.last_kf_pose
    assert int(fresh.loops_closed) == 0


def test_global_map_points_match_the_jax_package(saved):
    """The same keyframe store in both packages: the same world-frame map,
    point for point (one rigid transform per keyframe, fp32)."""
    cfg, *_, engine, path = saved
    got = texport.global_map_points(engine)
    je = jexport.load_checkpoint(path, jp.SlamEngine(cfg))
    want = jexport.global_map_points(je)
    assert got.shape == want.shape and got.dtype == np.float32
    assert len(got) > 500
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert texport.global_map_points(
        tp.SlamEngine(cfg, device="cpu")).shape == (0, 3)
    assert texport.global_map_points(engine, max_points=100).shape == (100, 3)


def test_ply_and_tum_bytes_equal_the_jax_package(saved, tmp_path):
    cfg, *_, engine, _ = saved
    pts = texport.global_map_points(engine)[:200]
    est, times = engine.trajectory_array(), engine.trajectory_times()
    # One pose turned by half a turn about z takes the axis-angle branch.
    est = est.copy()
    est[2, :3, :3] = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    files = {}
    for tag, mod in (("t", texport), ("j", jexport)):
        ply, tum = tmp_path / f"{tag}.ply", tmp_path / f"{tag}.txt"
        mod.save_ply(str(ply), pts)
        mod.save_trajectory_tum(str(tum), times, est)
        files[tag] = (ply.read_bytes(), tum.read_bytes())
    assert files["t"][0] == files["j"][0]
    assert files["t"][1] == files["j"][1]
    assert files["t"][0].startswith(b"ply\nformat ascii 1.0\n"
                                    b"element vertex 200\n")
    assert len(files["t"][1].splitlines()) == N_SAVED
