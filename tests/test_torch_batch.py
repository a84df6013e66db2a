"""The port's multi-sequence ``BatchEngine`` (``parallel/batch.py``) against
the JAX package's: one batched perception + mapping step from a JAX state
carried across by ``utils/convert``, a 5-scan drive of two sequences
through both, each sequence of the batch against the port's own
single-sequence functions (the batched loop tick is in
tests/test_torch_batch_loop.py, the merge in tests/test_torch_merge.py).  The kNN
runs through its custom op under ``torch.func.vmap`` (the plain version on
the CPU), so no functorch per-sample fallback may appear."""

import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu.parallel import batch as jb
from sc_lego_loam_tpu.utils import synthetic
from sc_lego_loam_tpu_torch import mapping as tmapping, odometry as todo
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch
from sc_lego_loam_tpu_torch.models import scan_context as tsc
from sc_lego_loam_tpu_torch.parallel import batch as tb
from sc_lego_loam_tpu_torch.pipeline import _odo_perception
from sc_lego_loam_tpu_torch.utils import convert

torch.set_num_threads(1)

N = 5             # scans of the drive (tests/test_batch.py::_drive_pair)
CARRY = 3         # the step compared from a carried state: a mapping tick


def _fewer_iterations(cfg):
    """tiny_test_config() with the LM iteration caps halved (odometry 12 ->
    6, scan-to-map 8 -> 4) in both packages: the JAX package unrolls these
    loops, and its BatchEngine compiles in 32 s instead of 55 s on one CPU
    thread."""
    return cfg.replace(
        odom=dataclasses.replace(cfg.odom, max_iterations=6),
        mapping=dataclasses.replace(cfg.mapping, max_iterations=4))


def _numpy(tree):
    return jax.tree.map(np.array, tree)


def _snapshot(eng):
    """The JAX engine's state as numpy (the steps donate their inputs)."""
    return types.SimpleNamespace(
        odo=_numpy(eng.odo), map=_numpy(eng.map), bank=_numpy(eng.bank),
        loops=_numpy(eng.loops), last_kf_odom=np.array(eng.last_kf_odom),
        loops_closed=np.array(eng.loops_closed), traj=np.array(eng.traj),
        _scan_i=eng._scan_i, _map_ticks=eng._map_ticks,
        last_map_time=eng.last_map_time)


def _item(state, s):
    """Sequence s of a leading-S state tuple, as its own tensors."""
    if isinstance(state, torch.Tensor):
        return state[s].clone()
    return type(state)(*(_item(leaf, s) for leaf in state))


def _no_fallback(caught):
    drops = [str(w.message) for w in caught
             if "performance drop" in str(w.message)]
    assert not drops, drops[:3]


def jax_drive():
    """The two sequences of tests/test_batch.py::_drive_pair through ONE JAX
    BatchEngine (its jit compiles are per engine), with its state kept
    before and after step CARRY."""
    cfg = _fewer_iterations(tiny_test_config())
    s0, v0, _ = synthetic.make_sequence(cfg.lidar, N, step=0.4, seed=7)
    s1, v1, _ = synthetic.make_sequence(cfg.lidar, N, step=0.4, seed=7,
                                        yaw_rate=0.05)
    pts = np.stack([s0, s1], 1)            # (N, S, points, 3)
    msk = np.stack([v0, v1], 1)
    eng = jb.BatchEngine(cfg, n_seq=2)
    snaps = {}
    for i in range(N):
        if i == CARRY:
            snaps["before"] = _snapshot(eng)
        eng.process_scans(pts[i], msk[i], t=i * 0.1)
        if i == CARRY:
            snaps["after"] = _snapshot(eng)
    return _fewer_iterations(tiny_torch()), pts, msk, eng, snaps


@pytest.fixture(scope="module")
def pair():
    return jax_drive()


def _rot_deg(a, b):
    R = np.einsum("...ji,...jk->...ik", a[..., :3, :3], b[..., :3, :3])
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(c))


def test_batched_steps_from_carried_state(pair):
    """Scan CARRY (perception + a mapping tick, a keyframe inserted in both
    sequences) from the JAX state before it.  The odometry agrees to 1e-4,
    and so do the keyframe rows that do not pass through the scan-to-map
    plane fits: the sensor-frame clouds and their masks, the time, the raw
    odometry pose, and the descriptor rows.  The mapped pose agrees with
    the (jitted) JAX package to 0.05 m / 0.5 deg: its plane fits are fp32
    normal equations, and the JAX package's own jitted and eager runs of
    this very step lie 0.0063 m / 0.337 deg apart, while the port is
    within 5e-7 m / 0 deg of the eager run (tests/torch_jit_spread.py).  It
    agrees with the port's unbatched mapping tick from the same state to
    1e-4.  The step raises no per-sample fallback warning."""
    cfg, pts, msk, _, snaps = pair
    eng = tb.BatchEngine(cfg, n_seq=2, device="cpu")
    convert.load_batch_state(eng, snaps["before"])
    odo_in, map_in, lko_in = eng.odo, eng.map, eng.last_kf_odom
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fused = eng.process_scans(pts[CARRY], msk[CARRY], t=CARRY * 0.1)
    _no_fallback(caught)
    want = snaps["after"]
    assert eng._map_ticks == want._map_ticks
    np.testing.assert_allclose(eng.odo.pose.numpy(), want.odo.pose,
                               atol=1e-4)
    np.testing.assert_allclose(eng.odo.motion.numpy(), want.odo.motion,
                               atol=1e-4)
    pose_t, pose_j = eng.map.pose.numpy(), want.map.pose
    assert np.linalg.norm(pose_t[:, :3, 3] - pose_j[:, :3, 3], axis=-1
                          ).max() < 0.05
    assert _rot_deg(pose_t, pose_j).max() < 0.5
    np.testing.assert_array_equal(eng.map.kf.count.numpy(),
                                  want.map.kf.count)
    np.testing.assert_array_equal(eng.bank.count.numpy(), want.bank.count)
    assert (want.map.kf.count > snaps["before"].map.kf.count).all()
    k = int(want.map.kf.count.max())
    kf_t, kf_j = eng.map.kf, want.map.kf
    for name in ("corner", "surf", "outlier"):
        mask_t = getattr(kf_t, name + "_mask").numpy()[:, :k]
        mask_j = getattr(kf_j, name + "_mask")[:, :k]
        np.testing.assert_array_equal(mask_t, mask_j)
        np.testing.assert_allclose(
            np.where(mask_t[..., None], getattr(kf_t, name).numpy()[:, :k], 0),
            np.where(mask_j[..., None], getattr(kf_j, name)[:, :k], 0),
            atol=1e-5)
    np.testing.assert_array_equal(kf_t.times.numpy()[:, :k], kf_j.times[:, :k])
    np.testing.assert_allclose(kf_t.odom_pose.numpy()[:, :k],
                               kf_j.odom_pose[:, :k], atol=1e-4)
    np.testing.assert_allclose(eng.bank.desc.numpy()[:, :k],
                               want.bank.desc[:, :k], atol=1e-5)

    # The same tick, unbatched, sequence by sequence, from the same state.
    for s in range(2):
        odo, odom_pose, out_pts, out_mask = _odo_perception(
            cfg, torch.from_numpy(pts[CARRY, s]),
            torch.from_numpy(msk[CARRY, s]), _item(odo_in, s))
        np.testing.assert_allclose(odom_pose.numpy(),
                                   eng.odo.pose.numpy()[s], atol=1e-6)
        st = _item(map_in, s)
        _, rows, ins, pose, corr, _, lko = tb._map_one(
            cfg, st, lko_in[s], odom_pose, odo.corner_last.xyz,
            odo.corner_last.mask, odo.surf_last.xyz, odo.surf_last.mask,
            out_pts, out_mask, torch.tensor(CARRY * 0.1))
        np.testing.assert_allclose(pose.numpy(), pose_t[s], atol=1e-4)
        np.testing.assert_allclose(corr.numpy(),
                                   eng.map.correction.numpy()[s], atol=1e-4)
        np.testing.assert_allclose(fused.numpy()[s],
                                   (corr @ odom_pose).numpy(), atol=1e-4)
        assert bool(ins) == bool(eng.map.kf.count[s] > map_in.kf.count[s])


@pytest.fixture(scope="module")
def port_drive(pair):
    cfg, pts, msk, _, _ = pair
    eng = tb.BatchEngine(cfg, n_seq=2, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(N):
            eng.process_scans(pts[i], msk[i], t=i * 0.1)
    return eng, caught


def test_drive_matches_jax_batch_engine(pair, port_drive):
    """tests/test_batch.py::_drive_pair through both packages: the same
    keyframe counts, trajectories within 5 cm."""
    _, _, _, jeng, _ = pair
    eng, caught = port_drive
    _no_fallback(caught)
    np.testing.assert_array_equal(eng.map.kf.count.numpy(),
                                  np.asarray(jeng.map.kf.count))
    np.testing.assert_array_equal(eng.bank.count.numpy(),
                                  np.asarray(jeng.bank.count))
    got, want = eng.trajectory_array(), jeng.trajectory_array()
    assert got.shape == want.shape == (2, N, 4, 4)
    np.testing.assert_allclose(got[:, :, :3, 3], want[:, :, :3, 3],
                               atol=5e-2)
    assert np.allclose(eng.trajectory_array(1), got[1])


def test_batch_equals_single_sequence_functions(pair, port_drive):
    """Sequence s of the batch against the port's single-sequence functions
    (``_odo_perception`` and the mapping tick, with the JAX BatchEngine's
    keyframe and descriptor rules) driven on sequence s alone."""
    cfg, pts, msk, _, _ = pair
    eng, _ = port_drive
    traj = eng.trajectory_array()
    for s in range(2):
        odo = todo.init_state(cfg, "cpu")
        ms = tmapping.init_state(cfg, "cpu")
        bank = tsc.init_bank(cfg, "cpu")
        lko = torch.eye(4)
        last_map = -1e9
        for i in range(N):
            p, m = torch.from_numpy(pts[i, s]), torch.from_numpy(msk[i, s])
            odo, odom_pose, out_pts, out_mask = _odo_perception(cfg, p, m,
                                                                odo)
            t = i * 0.1
            if t - last_map >= cfg.mapping.process_interval:
                last_map = t
                slot, rows, ins, pose, corr, lkp, lko = tb._map_one(
                    cfg, ms, lko, odom_pose, odo.corner_last.xyz,
                    odo.corner_last.mask, odo.surf_last.xyz,
                    odo.surf_last.mask, out_pts, out_mask, torch.tensor(t))
                for name, row in rows.items():
                    getattr(ms.kf, name)[slot] = row
                ms = tmapping.MapState(
                    kf=ms.kf._replace(count=ms.kf.count + ins.int()),
                    correction=corr, pose=pose, last_kf_pose=lkp)
                bank = tsc.append(bank, tsc.make_descriptor(p, m, cfg.sc),
                                  cfg.cap.max_keyframes, ins)
            np.testing.assert_allclose(
                (ms.correction @ odom_pose).numpy(), traj[s, i], atol=1e-4)
        assert int(ms.kf.count) == int(eng.map.kf.count[s])
        assert int(bank.count) == int(eng.bank.count[s])
        np.testing.assert_allclose(bank.desc.numpy(), eng.bank.desc[s],
                                   atol=1e-6)


def test_batch_engine_refuses_mesh_and_imu():
    cfg = tiny_torch()
    with pytest.raises(NotImplementedError, match="mesh"):
        tb.BatchEngine(cfg, n_seq=2, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="imu"):
        tb.BatchEngine(cfg.replace(imu=dataclasses.replace(
            cfg.imu, enabled=True)), n_seq=2, device="cpu")
