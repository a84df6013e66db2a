"""Reverse-direction loop closure in the port (torch twin of
tests/test_reverse_loop.py): the Scan Context yaw seeds the verification
ICP, so a 180-degree revisit closes; and the two submap rules of
``mapping.build_submap`` on one keyframe store."""

import dataclasses

import numpy as np
import torch

from sc_lego_loam_tpu_torch import mapping
from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.pipeline import SlamEngine
from sc_lego_loam_tpu_torch.utils import evaluate, synthetic

torch.set_num_threads(1)


def _out_and_back(n, step=0.7, height=2.0, turn_frames=8):
    """Drive +x, U-turn over a few frames, come back along the same street
    facing -x."""
    half = (n - turn_frames) // 2
    poses = []
    x, y, yaw = 0.0, 0.0, 0.0
    for i in range(n):
        c, s = np.cos(yaw), np.sin(yaw)
        poses.append(np.array([[c, -s, 0, x], [s, c, 0, y],
                               [0, 0, 1, height], [0, 0, 0, 1]], np.float32))
        if i < half:
            s_i = step                # straight out
        elif i < half + turn_frames:
            yaw += np.pi / turn_frames  # tight U-turn (short steps), so the
            s_i = 0.2                   # return street nearly overlays the
        else:                           # outbound one
            s_i = step
        x += s_i * np.cos(yaw)
        y += s_i * np.sin(yaw)
    return np.stack(poses)


def test_reverse_loop_closes():
    cfg = tiny_test_config()
    cfg = cfg.replace(
        sc=dataclasses.replace(cfg.sc, exclude_recent=8),
        loop=dataclasses.replace(cfg.loop, check_every_ticks=2,
                                 rs_time_gap=1e9))   # force the SC path
    n = 56
    gt = _out_and_back(n)
    world = synthetic.default_world(seed=3)
    rng = np.random.default_rng(4)
    engine = SlamEngine(cfg, device="cpu")
    for i in range(n):
        pts, valid = synthetic.raycast(world, gt[i], cfg.lidar, noise=0.01,
                                       rng=rng)
        perm = rng.permutation(pts.shape[0])
        engine.process_scan(pts[perm], valid[perm], t=i * 0.1)
    est = engine.trajectory_array()
    assert np.isfinite(est).all()
    assert int(engine.loops_closed) >= 1, \
        "reverse revisit produced no loop closure"
    ate = evaluate.ate_rmse(est, gt[: len(est)])
    # Smoke floor only, as in the reference test: the 16x128 tiny sensor
    # drifts ~2 m in z over this 40 m out-and-back; the point is that
    # reversed revisits CLOSE.
    assert ate < 2.5, f"ATE {ate}"


def test_loop_on_recent_submap_and_loop_off_radius_submap():
    """Loop closure ON takes the most recent keyframes, OFF those within a
    radius of the latest pose (mO.cpp:1127-1222)."""
    cfg = tiny_test_config()
    cfg_off = cfg.replace(
        loop=dataclasses.replace(cfg.loop, enabled=False),
        mapping=dataclasses.replace(cfg.mapping, submap_recent_num=4,
                                    submap_search_radius=5.0))
    cap = cfg_off.cap
    kf = mapping.init_state(cfg_off, "cpu").kf
    # 10 keyframes marching +x by 10 m; the LAST is back at the origin.
    rng = np.random.default_rng(0)
    for k in range(10):
        x = 0.0 if k == 9 else k * 10.0
        pose = torch.eye(4)
        pose[0, 3] = x
        pts = torch.from_numpy(
            rng.normal(0, 1, (cap.kf_corner_pad, 3)).astype(np.float32)) \
            + torch.tensor([x, 0.0, 0.0])
        kf, _ = mapping.insert_keyframe(
            cfg_off, kf, torch.tensor(True), pose, torch.tensor(float(k)),
            pts, torch.ones(cap.kf_corner_pad, dtype=torch.bool),
            torch.zeros(cap.kf_surf_pad, 3),
            torch.zeros(cap.kf_surf_pad, dtype=torch.bool),
            torch.zeros(cap.kf_outlier_pad, 3),
            torch.zeros(cap.kf_outlier_pad, dtype=torch.bool))
    c, cm, _, _ = mapping.build_submap(cfg_off, kf)
    pts = c.numpy()[cm.numpy()]
    # Radius 5 m around the origin: only keyframes 0 and 9 qualify.
    assert len(pts) > 0
    assert np.abs(pts[:, 0]).max() < 15.0, np.abs(pts[:, 0]).max()

    # The same store with loop closure ON picks the most recent 4
    # (x = 60, 70, 80 and the one at the origin).
    cfg_on = cfg.replace(
        mapping=dataclasses.replace(cfg.mapping, submap_recent_num=4))
    c2, cm2, _, _ = mapping.build_submap(cfg_on, kf)
    pts2 = c2.numpy()[cm2.numpy()]
    assert pts2[:, 0].max() > 60.0
    assert not ((pts2[:, 0] > 15.0) & (pts2[:, 0] < 45.0)).any()
    # Fewer keyframes than the submap takes: the missing ones are masked.
    kf2 = kf._replace(count=torch.tensor(2, dtype=torch.int32))
    c3, cm3, _, _ = mapping.build_submap(cfg_on, kf2)
    pts3 = c3.numpy()[cm3.numpy()]
    assert len(pts3) > 0 and pts3[:, 0].max() < 25.0
