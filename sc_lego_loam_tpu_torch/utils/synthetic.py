"""Synthetic LiDAR world: analytic raycaster for tests and benchmarks.

The reference is validated only on MulRan rosbags (README.md:22-29); since
the rebuild needs deterministic fixtures with analytically known geometry
(SURVEY.md par.4), this module raycasts a structured world — ground plane,
axis-aligned box "buildings" (planar walls -> surf features, vertical edges
-> corner features) and vertical cylinders ("pillars") — from arbitrary
sensor poses, producing scans in the sensor frame with exact beam geometry.

Host-side numpy: data generation is not on the device hot path.  This is
the package's own copy of ``sc_lego_loam_tpu/utils/synthetic.py`` and gives
the same arrays, bit for bit, for the same arguments; ``make_sequence`` can
also cast the rays of motion-skewed scans in worker processes
(``workers``), which changes no value.
"""

from __future__ import annotations

import dataclasses
import multiprocessing

import numpy as np

from ..config import LidarConfig

_INF = 1e9


@dataclasses.dataclass
class World:
    """Axis-aligned boxes (n,6: xmin ymin zmin xmax ymax zmax), vertical
    cylinders (m,4: cx cy r h), and a flat ground plane at z=0."""

    boxes: np.ndarray
    cylinders: np.ndarray
    ground_z: float = 0.0


def default_world(seed: int = 0, extent: float = 90.0, n_boxes: int = 40,
                  n_cyls: int = 60) -> World:
    """An urban-ish block world: buildings along two corridors + pillars."""
    rng = np.random.default_rng(seed)
    boxes = []
    # Street corridor along x: buildings on both sides of y = +-12.
    for i in range(n_boxes):
        side = 1 if i % 2 == 0 else -1
        cx = rng.uniform(-extent, extent)
        cy = side * rng.uniform(10.0, 28.0)
        w = rng.uniform(4.0, 14.0)
        d = rng.uniform(4.0, 14.0)
        h = rng.uniform(4.0, 18.0)
        boxes.append([cx - w / 2, cy - d / 2, 0.0, cx + w / 2, cy + d / 2, h])
    cyls = []
    for _ in range(n_cyls):
        cx = rng.uniform(-extent, extent)
        cy = rng.uniform(-12.0, 12.0)
        # keep the immediate origin area clear
        if abs(cx) < 6 and abs(cy) < 6:
            cx += 12.0
        r = rng.uniform(0.25, 0.9)
        h = rng.uniform(3.0, 9.0)
        cyls.append([cx, cy, r, h])
    return World(boxes=np.asarray(boxes, np.float64),
                 cylinders=np.asarray(cyls, np.float64))


def beam_directions(lidar: LidarConfig) -> np.ndarray:
    """Unit ray directions in the sensor frame, shape (n_scan, horizon, 3).

    Row r elevation = r*ang_res_y - ang_bottom (row 0 = lowest beam), column c
    azimuth = c*ang_res_x, matching ops/projection.py's inverse mapping.
    """
    elev = np.deg2rad(np.arange(lidar.n_scan) * lidar.ang_res_y - lidar.ang_bottom)
    azim = np.deg2rad(np.arange(lidar.horizon_scan) * lidar.ang_res_x)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(azim)[None, :], np.sin(azim)[None, :]
    shape = (lidar.n_scan, lidar.horizon_scan)
    return np.stack([ce * ca, ce * sa, np.broadcast_to(se, shape)], -1)


def _ray_ground(o, d, ground_z):
    """o: (3,) or (...,3) broadcastable to d's batch shape; d: (...,3)."""
    o = np.broadcast_to(o, d.shape)
    dz = d[..., 2]
    t = (ground_z - o[..., 2]) / np.where(np.abs(dz) < 1e-12, 1e-12, dz)
    return np.where((dz < -1e-9) & (t > 0), t, _INF)


def _ray_boxes(o, d, boxes):
    """Slab method, vectorized over rays x boxes. o:(...,3), d:(...,3)."""
    if boxes.shape[0] == 0:
        return np.full(d.shape[:-1], _INF)
    o = np.broadcast_to(o, d.shape)[..., None, :]   # (...,1,3)
    lo = boxes[:, :3]
    hi = boxes[:, 3:]
    dd = d[..., None, :]  # (...,1,3)
    inv = 1.0 / np.where(np.abs(dd) < 1e-12, 1e-12, dd)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = np.minimum(t0, t1).max(-1)
    tmax = np.maximum(t0, t1).min(-1)
    hit = (tmax >= np.maximum(tmin, 0)) & (tmin > 0)
    return np.where(hit, tmin, _INF).min(-1)


def _ray_cylinders(o, d, cyls):
    if cyls.shape[0] == 0:
        return np.full(d.shape[:-1], _INF)
    o = np.broadcast_to(o, d.shape)
    cx, cy, r, h = cyls[:, 0], cyls[:, 1], cyls[:, 2], cyls[:, 3]
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    ox = o[..., 0:1] - cx
    oy = o[..., 1:2] - cy
    a = dx * dx + dy * dy
    b = 2 * (dx * ox + dy * oy)
    c = ox * ox + oy * oy - r * r
    disc = b * b - 4 * a * c
    ok = disc > 0
    sq = np.sqrt(np.maximum(disc, 0))
    t = (-b - sq) / np.where(np.abs(a) < 1e-12, 1e-12, 2 * a)
    z = o[..., 2:3] + t * dz
    hit = ok & (t > 0) & (z >= 0) & (z <= h)
    return np.where(hit, t, _INF).min(-1)


def raycast(world: World, pose: np.ndarray, lidar: LidarConfig,
            noise: float = 0.0, rng=None, drop_rate: float = 0.0):
    """Raycast one scan from a 4x4 world-from-sensor pose.

    Returns (points, valid): points (n_scan*horizon, 3) in the SENSOR frame
    (invalid rays zeroed), valid bool mask. Points are beam-ordered; callers
    that want an unordered cloud should shuffle.
    """
    R, p = pose[:3, :3], pose[:3, 3]
    dirs_s = beam_directions(lidar)                       # sensor frame
    dirs_w = dirs_s @ R.T
    t = np.minimum.reduce([
        _ray_ground(p, dirs_w, world.ground_z),
        _ray_boxes(p, dirs_w, world.boxes),
        _ray_cylinders(p, dirs_w, world.cylinders),
    ])
    valid = (t > lidar.min_range) & (t < min(lidar.max_range, 1e8))
    if rng is None:
        rng = np.random.default_rng(0)
    if noise > 0:
        t = t + rng.normal(0, noise, t.shape)
    if drop_rate > 0:
        valid &= rng.random(t.shape) > drop_rate
    pts = dirs_s * np.where(valid, t, 0.0)[..., None]
    return pts.reshape(-1, 3).astype(np.float32), valid.reshape(-1)


def _so3_log(R):
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(tr)
    if th < 1e-9:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2.0 * np.sin(th)) * w


def _so3_exp(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _skewed_ranges(world: World, pose0: np.ndarray, pose1: np.ndarray,
                   lidar: LidarConfig) -> np.ndarray:
    """Noise-free ranges (H,W) of one motion-distorted scan: the ray
    casting of ``raycast_skewed``, which draws nothing from an rng and so
    can run in any process."""
    W = lidar.horizon_scan
    dirs_s = beam_directions(lidar)                       # (H,W,3)
    w_rel = _so3_log(pose0[:3, :3].T @ pose1[:3, :3])
    fracs = np.arange(W) / W
    # Per-column world pose (rotation exp-interp, translation lerp).
    R0 = pose0[:3, :3]
    Rc = np.stack([R0 @ _so3_exp(f * w_rel) for f in fracs])   # (W,3,3)
    pc = pose0[:3, 3][None] * (1 - fracs[:, None]) + \
        pose1[:3, 3][None] * fracs[:, None]               # (W,3)
    # World-frame ray dirs: dirs_w[h,c] = Rc[c] @ dirs_s[h,c]
    dirs_w = np.einsum("cij,hcj->hci", Rc, dirs_s)
    origins = np.broadcast_to(pc[None], dirs_w.shape)
    return np.minimum.reduce([
        _ray_ground(origins, dirs_w, world.ground_z),
        _ray_boxes(origins, dirs_w, world.boxes),
        _ray_cylinders(origins, dirs_w, world.cylinders),
    ])


def raycast_skewed(world: World, pose0: np.ndarray, pose1: np.ndarray,
                   lidar: LidarConfig, noise: float = 0.0, rng=None,
                   ranges: np.ndarray | None = None):
    """Raycast one MOTION-DISTORTED scan: each azimuth column c is captured
    from the pose interpolated at fraction c/W along pose0 -> pose1 (the
    intra-scan sweep), and its returns are expressed in THAT column's
    sensor frame — exactly the skew a spinning lidar produces and the
    reference undoes via TransformToStart (fA.cpp:860-883).

    Points are emitted in CAPTURE ORDER (column-major: all beams of
    azimuth column 0 first, then column 1, ...), matching real
    spinning-lidar packet order — the engine's azimuth-span rel_time
    (ops/projection.py) anchors the sweep at the FIRST point's azimuth,
    so the first array entries must be the earliest-captured columns.

    ``ranges``: the scan's ``_skewed_ranges`` when already cast (by a
    worker process of ``make_sequence``).

    Returns (points (n_scan*horizon,3) capture-ordered, valid)."""
    dirs_s = beam_directions(lidar)                       # (H,W,3)
    t = ranges if ranges is not None else \
        _skewed_ranges(world, pose0, pose1, lidar)
    valid = (t > lidar.min_range) & (t < min(lidar.max_range, 1e8))
    if rng is None:
        rng = np.random.default_rng(0)
    if noise > 0:
        t = t + rng.normal(0, noise, t.shape)
    pts = dirs_s * np.where(valid, t, 0.0)[..., None]
    pts = np.swapaxes(pts, 0, 1)        # (W,H,3): capture order
    valid = np.swapaxes(valid, 0, 1)
    return pts.reshape(-1, 3).astype(np.float32), valid.reshape(-1)


def figure8_trajectory(n_poses: int, radius: float = 40.0, height: float = 2.0,
                       loops: float = 1.0) -> np.ndarray:
    """World-from-sensor poses along a figure-8 (guaranteed revisits for
    loop-closure tests). Returns (n,4,4); x-axis tangent to the path."""
    s = np.linspace(0, 2 * np.pi * loops, n_poses, endpoint=False)
    x = radius * np.sin(s)
    y = 0.5 * radius * np.sin(2 * s)
    dx = radius * np.cos(s)
    dy = radius * np.cos(2 * s)
    yaw = np.arctan2(dy, dx)
    poses = np.zeros((n_poses, 4, 4))
    cy, sy = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0] = cy
    poses[:, 0, 1] = -sy
    poses[:, 1, 0] = sy
    poses[:, 1, 1] = cy
    poses[:, 2, 2] = 1.0
    poses[:, 0, 3] = x
    poses[:, 1, 3] = y
    poses[:, 2, 3] = height
    poses[:, 3, 3] = 1.0
    return poses


def cloverleaf_trajectory(n_poses: int, radius: float = 40.0,
                          height: float = 2.0, petals: int = 4) -> np.ndarray:
    """Rose-curve trajectory r = R sin(p/2 * theta): ``petals`` petals all
    passing through the ORIGIN, so the center is revisited petals-1 times
    after the first pass — multiple distinct loop-closure opportunities for
    precision/recall benchmarking (a figure-8 yields only one revisit
    event).  Returns (n,4,4); x-axis tangent to the path."""
    s = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
    k = petals / 2.0
    r = radius * np.sin(k * s)
    x = r * np.cos(s)
    y = r * np.sin(s)
    dr = radius * k * np.cos(k * s)
    dx = dr * np.cos(s) - r * np.sin(s)
    dy = dr * np.sin(s) + r * np.cos(s)
    yaw = np.arctan2(dy, dx)
    poses = np.zeros((n_poses, 4, 4))
    cy, sy = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0] = cy
    poses[:, 0, 1] = -sy
    poses[:, 1, 0] = sy
    poses[:, 1, 1] = cy
    poses[:, 2, 2] = 1.0
    poses[:, 0, 3] = x
    poses[:, 1, 3] = y
    poses[:, 2, 3] = height
    poses[:, 3, 3] = 1.0
    return poses


def straight_trajectory(n_poses: int, step: float = 0.4, height: float = 2.0,
                        yaw_rate: float = 0.0) -> np.ndarray:
    """Constant-velocity (optionally turning) trajectory."""
    poses = np.zeros((n_poses, 4, 4))
    x = y = yaw = 0.0
    for i in range(n_poses):
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i] = np.array([[c, -s, 0, x], [s, c, 0, y],
                             [0, 0, 1, height], [0, 0, 0, 1]])
        x += step * c
        y += step * s
        yaw += yaw_rate
    return poses


def make_imu_samples(poses: np.ndarray, t0: float = 0.0,
                     period: float = 0.1, rate_hz: float = 100.0,
                     seed: int = 0, noise_rpy: float = 0.003,
                     noise_acc: float = 0.05, noise_gyro: float = 0.003):
    """Synthesize a 9-axis IMU stream from a pose trajectory.

    ``poses`` (n,4,4) world-from-sensor at times t0 + k*period.  Returns
    (times (M,), rpy (M,3), acc (M,3), gyro (M,3)) matching the
    SlamEngine.push_imu contract (imuHandler, fA.cpp:431-489): world
    roll/pitch/yaw (an AHRS attitude), body linear acceleration WITH
    gravity, body angular rate.  Noise defaults model a consumer-grade
    MEMS unit (~0.17 deg attitude, 0.05 m/s^2 accel, 0.17 deg/s gyro).

    The reference's entire IMU usage (de-skew + initial guess + roll/pitch
    blend) consumes exactly these channels; MulRan itself ships no IMU in
    the scans, so this is the test/bench-side sensor model.
    """
    n = len(poses)
    T = period
    g = 9.81
    pos = poses[:, :3, 3]
    # Knot velocity/acceleration by central differences (the trajectory
    # generators are smooth; one-sided at the ends).
    vel = np.gradient(pos, T, axis=0)
    acc_w = np.gradient(vel, T, axis=0)
    # Knot body rates: omega_i ~ log(R_i^T R_{i+1}) / T (one-sided at end).
    omega = np.zeros((n, 3))
    for i in range(n - 1):
        omega[i] = _so3_log(poses[i][:3, :3].T @ poses[i + 1][:3, :3]) / T
    omega[-1] = omega[-2] if n > 1 else 0.0

    rng = np.random.default_rng(seed)
    m = int(np.floor((n - 1) * T * rate_hz)) + 1
    times = t0 + np.arange(m) / rate_hz
    rpy = np.zeros((m, 3), np.float32)
    acc = np.zeros((m, 3), np.float32)
    gyro = np.zeros((m, 3), np.float32)
    for k, t in enumerate(times - t0):
        i = min(int(t / T), n - 2) if n > 1 else 0
        f = np.clip(t / T - i, 0.0, 1.0)
        R0, R1 = poses[i][:3, :3], poses[min(i + 1, n - 1)][:3, :3]
        R = R0 @ _so3_exp(f * _so3_log(R0.T @ R1))
        a_w = (1 - f) * acc_w[i] + f * acc_w[min(i + 1, n - 1)]
        w_b = (1 - f) * omega[i] + f * omega[min(i + 1, n - 1)]
        # roll/pitch/yaw of R (zyx convention: R = Rz(yaw)Ry(pitch)Rx(roll)).
        yaw = np.arctan2(R[1, 0], R[0, 0])
        pitch = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
        roll = np.arctan2(R[2, 1], R[2, 2])
        rpy[k] = [roll, pitch, yaw]
        acc[k] = R.T @ (a_w + np.array([0.0, 0.0, g]))
        gyro[k] = w_b
    rpy += rng.normal(0, noise_rpy, rpy.shape).astype(np.float32)
    acc += rng.normal(0, noise_acc, acc.shape).astype(np.float32)
    gyro += rng.normal(0, noise_gyro, gyro.shape).astype(np.float32)
    return times.astype(np.float64), rpy, acc, gyro


def make_sequence(lidar: LidarConfig, n_scans: int, *, seed: int = 0,
                  trajectory: str = "straight", noise: float = 0.01,
                  shuffle: bool = True, skew: bool = False,
                  workers: int = 1, **traj_kw):
    """Generate a full synthetic sequence.

    ``skew=True`` emits motion-distorted scans (each azimuth column
    raycast from its capture-time pose, see raycast_skewed) — the input
    the real-data deskew path (OdometryConfig.deskew=True) expects.
    Ground truth for scan i is then its SCAN-END pose (odometry tracks
    scan-end frames, TransformToEnd fA.cpp:885-953).

    ``workers`` > 1 casts the rays of skewed scans in that many processes;
    the noise and the shuffle are still drawn here, scan by scan from the
    one rng, so the arrays equal the serial ones.

    Returns (scans, valids, poses): scans (n, N, 3) sensor-frame clouds,
    valids (n, N) masks, poses (n, 4, 4) ground-truth world-from-sensor.
    """
    world = default_world(seed=seed)
    n_gen = n_scans + 1 if skew else n_scans
    if trajectory == "straight":
        poses = straight_trajectory(n_gen, **traj_kw)
    elif trajectory == "figure8":
        poses = figure8_trajectory(n_gen, **traj_kw)
    elif trajectory == "cloverleaf":
        poses = cloverleaf_trajectory(n_gen, **traj_kw)
    else:
        raise ValueError(trajectory)
    rng = np.random.default_rng(seed + 1)
    ranges = [None] * n_scans
    if skew and workers > 1:
        jobs = [(world, poses[i], poses[i + 1], lidar)
                for i in range(n_scans)]
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            ranges = pool.starmap(_skewed_ranges, jobs)
    scans, valids = [], []
    for i in range(n_scans):
        if skew:
            pts, valid = raycast_skewed(world, poses[i], poses[i + 1],
                                        lidar, noise=noise, rng=rng,
                                        ranges=ranges[i])
        else:
            pts, valid = raycast(world, poses[i], lidar, noise=noise, rng=rng)
        if shuffle:
            perm = rng.permutation(pts.shape[0])
            pts, valid = pts[perm], valid[perm]
        scans.append(pts)
        valids.append(valid)
    gt = poses[1:n_scans + 1] if skew else poses
    return np.stack(scans), np.stack(valids), gt.astype(np.float32)
