"""Drives cast on the device: the benchmark's own frozen copy of the
synthetic world, trajectories and motion-skewed ray caster of the port's
``utils/synthetic`` (ground plane, axis-aligned boxes by the slab test,
vertical cylinders, a pose per azimuth column), in torch.

A drive is made from a traffic mix (``traffic/<name>.json``) and a seed:
each stream's world from the mix's fixed world seeds (the same boxes and
cylinders as the port's ``default_world``), the ground-truth poses from
the mix's trajectory, the scans cast in float64 in chunks on the device,
range noise drawn from the run's seed by a ``torch.Generator`` on that
device, then moved to host numpy as a sensor driver would deliver them:
float32 points in capture order (column-major) and a bool validity mask.
The worlds are fixed so that every seed asks for the same work (the
places, hence the loop ticks that verify and close); the seed changes
the noise on every range.

A configuration with an ``imu_stream`` block also gets a 9-axis IMU
stream for each stream, cast on the device from the same trajectory
(``imu_samples``: the port's ``utils/synthetic.make_imu_samples``, frozen
here), its noise from a generator of its own, so that the scans are the
same with or without it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

_INF = 1e9
SCAN_PERIOD = 0.1          # seconds between scans (10 Hz)
GRAVITY = 9.81             # m/s^2, along the world's +z in the readings


class Imu(NamedTuple):
    """The IMU stream of a drive, on the host, in the contract of the
    port's ``SlamEngine.push_imu``: world roll/pitch/yaw (zyx), body
    linear acceleration with gravity, body angular rate."""

    times: np.ndarray      # (M,) float64 s, scan i spans [i, i+1] periods
    rpy: np.ndarray        # (M, S, 3) float32 rad
    acc: np.ndarray        # (M, S, 3) float32 m/s^2
    gyro: np.ndarray       # (M, S, 3) float32 rad/s
    ends: np.ndarray       # (n,) the samples due by the end of scan i:
                           # times[:ends[i]]


class Drive(NamedTuple):
    """One drive of ``n`` scans for ``S`` streams, on the host."""

    scans: np.ndarray      # (n, S, N, 3) float32, sensor frame
    valids: np.ndarray     # (n, S, N) bool
    seeds: tuple           # the noise seed of each stream
    imu: Imu | None = None  # None where the configuration has no stream


def world_arrays(seed: int, extent: float = 90.0, n_boxes: int = 40,
                 n_cyls: int = 60):
    """Boxes (n,6: xmin ymin zmin xmax ymax zmax) and cylinders (m,4: cx cy
    r h) of the block world: buildings along two corridors and pillars."""
    rng = np.random.default_rng(seed)
    boxes = []
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
        if abs(cx) < 6 and abs(cy) < 6:       # keep the origin clear
            cx += 12.0
        r = rng.uniform(0.25, 0.9)
        h = rng.uniform(3.0, 9.0)
        cyls.append([cx, cy, r, h])
    return np.asarray(boxes, np.float64), np.asarray(cyls, np.float64)


def beam_directions(lidar: dict, device, dtype=torch.float64):
    """Unit ray directions in the sensor frame, (n_scan, horizon, 3): row r
    at elevation r*ang_res_y - ang_bottom, column c at azimuth
    c*ang_res_x (degrees)."""
    elev = torch.deg2rad(torch.arange(lidar["n_scan"], dtype=dtype,
                                      device=device) * lidar["ang_res_y"]
                         - lidar["ang_bottom"])
    azim = torch.deg2rad(torch.arange(lidar["horizon_scan"], dtype=dtype,
                                      device=device) * lidar["ang_res_x"])
    ce, se = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(azim)[None, :], torch.sin(azim)[None, :]
    return torch.stack([ce * ca, ce * sa, se.expand(-1, azim.shape[0])], -1)


def _poses(x, y, dx, dy, height):
    """(n,4,4) world-from-sensor poses, x-axis tangent to the path."""
    yaw = torch.atan2(dy, dx)
    n = x.shape[0]
    P = torch.zeros((n, 4, 4), dtype=x.dtype, device=x.device)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    P[:, 0, 0], P[:, 0, 1], P[:, 1, 0], P[:, 1, 1] = cy, -sy, sy, cy
    P[:, 2, 2] = 1.0
    P[:, 0, 3], P[:, 1, 3], P[:, 2, 3] = x, y, height
    P[:, 3, 3] = 1.0
    return P


def trajectory(traffic: dict, n: int, device, dtype=torch.float64):
    """The first ``n`` poses of the mix's trajectory, one a scan (pose k at
    the parameter s_k = 2 pi k / scans_per_lap): a figure-8 (x = R sin s,
    y = R/2 sin 2s) or a rose of ``petals`` petals through the origin
    (r = R sin(p/2 s)), repeated for as many laps as ``n`` needs."""
    k = torch.arange(n, dtype=dtype, device=device)
    s = k * (2 * math.pi / traffic["scans_per_lap"])
    R, h = traffic["radius"], traffic["height"]
    if traffic["trajectory"] == "figure8":
        return _poses(R * torch.sin(s), 0.5 * R * torch.sin(2 * s),
                      R * torch.cos(s), R * torch.cos(2 * s), h)
    if traffic["trajectory"] == "cloverleaf":
        q = traffic["petals"] / 2.0
        r = R * torch.sin(q * s)
        dr = R * q * torch.cos(q * s)
        return _poses(r * torch.cos(s), r * torch.sin(s),
                      dr * torch.cos(s) - r * torch.sin(s),
                      dr * torch.sin(s) + r * torch.cos(s), h)
    raise ValueError(f"unknown trajectory {traffic['trajectory']!r}")


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_log(R):
    """(...,3,3) -> (...,3); the rotations here are far from pi."""
    cos = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2,
                      -1.0, 1.0)
    th = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    small = th < 1e-9
    f = torch.where(small, torch.full_like(th, 0.5),
                    th / (2 * torch.sin(torch.where(small, 1.0, th))))
    return torch.where(small[..., None], 0.0, f[..., None] * w)


def so3_exp(w):
    """Rodrigues: (...,3) -> (...,3,3)."""
    th = torch.linalg.vector_norm(w, dim=-1)[..., None, None]
    small = th < 1e-12
    ths = torch.where(small, 1.0, th)
    K = _hat(w) / ths
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R = eye + torch.sin(ths) * K + (1 - torch.cos(ths)) * (K @ K)
    return torch.where(small, eye, R)


def _hits(o, d, boxes, cyls, ground_z=0.0):
    """Nearest hit distance of rays o + t d over the ground plane, the
    boxes (slab test) and the cylinders; o, d (...,3)."""
    dz = d[..., 2]
    tg = (ground_z - o[..., 2]) / torch.where(dz.abs() < 1e-12, 1e-12, dz)
    t = torch.where((dz < -1e-9) & (tg > 0), tg, _INF)
    if boxes.shape[0]:
        oo, dd = o[..., None, :], d[..., None, :]
        inv = 1.0 / torch.where(dd.abs() < 1e-12, 1e-12, dd)
        t0 = (boxes[:, :3] - oo) * inv
        t1 = (boxes[:, 3:] - oo) * inv
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        hit = (tmax >= tmin.clamp(min=0)) & (tmin > 0)
        t = torch.minimum(t, torch.where(hit, tmin, _INF).amin(-1))
    if cyls.shape[0]:
        cx, cy, r, h = cyls.unbind(-1)
        dx, dy, dzz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
        ox, oy = o[..., 0:1] - cx, o[..., 1:2] - cy
        a = dx * dx + dy * dy
        b = 2 * (dx * ox + dy * oy)
        c = ox * ox + oy * oy - r * r
        disc = b * b - 4 * a * c
        tc = (-b - torch.sqrt(disc.clamp(min=0))) / \
            torch.where(a.abs() < 1e-12, 1e-12, 2 * a)
        z = o[..., 2:3] + tc * dzz
        hit = (disc > 0) & (tc > 0) & (z >= 0) & (z <= h)
        t = torch.minimum(t, torch.where(hit, tc, _INF).amin(-1))
    return t


def skewed_ranges(P0, P1, dirs_s, boxes, cyls):
    """Noise-free ranges (B,H,W) of B motion-skewed scans: column c cast
    from the pose a fraction c/W along P0 -> P1 (rotation by the
    exponential map, translation linearly)."""
    W = dirs_s.shape[1]
    frac = torch.arange(W, dtype=P0.dtype, device=P0.device) / W
    R0, R1 = P0[:, :3, :3], P1[:, :3, :3]
    w_rel = so3_log(R0.transpose(-1, -2) @ R1)                  # (B,3)
    Rc = R0[:, None] @ so3_exp(frac[None, :, None] * w_rel[:, None])
    pc = P0[:, None, :3, 3] * (1 - frac[None, :, None]) + \
        P1[:, None, :3, 3] * frac[None, :, None]                 # (B,W,3)
    dirs_w = torch.einsum("bcij,hcj->bhci", Rc, dirs_s)
    return _hits(pc[:, None].expand_as(dirs_w), dirs_w, boxes, cyls)


def cast(lidar: dict, poses, seed: int, noise: float, boxes, cyls,
         chunk: int = 8, gen=None):
    """Scans 0..n-1 of one stream from the n+1 poses ``poses`` (scan i is
    swept from pose i to pose i+1): (points (n,N,3) float32 in capture
    order, valid (n,N) bool), on the poses' device."""
    dev = poses.device
    dirs_s = beam_directions(lidar, dev, poses.dtype)             # (H,W,3)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    lo, hi = lidar["min_range"], min(lidar["max_range"], 1e8)
    n = poses.shape[0] - 1
    pts_out, valid_out = [], []
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        t = skewed_ranges(poses[a:b], poses[a + 1:b + 1], dirs_s, boxes,
                          cyls)
        valid = (t > lo) & (t < hi)
        if noise > 0:
            t = t + noise * torch.randn(t.shape, generator=gen,
                                        dtype=t.dtype, device=dev)
        pts = dirs_s * torch.where(valid, t, 0.0)[..., None]      # (B,H,W,3)
        pts_out.append(pts.transpose(1, 2).reshape(b - a, -1, 3)
                       .to(torch.float32))
        valid_out.append(valid.transpose(1, 2).reshape(b - a, -1))
    return torch.cat(pts_out), torch.cat(valid_out)


def _rate(x, period: float):
    """d/dt of knot values x (n, ...) ``period`` apart: central
    differences inside, one-sided at the ends (``numpy.gradient``)."""
    d = torch.empty_like(x)
    d[1:-1] = (x[2:] - x[:-2]) / (2 * period)
    d[0] = (x[1] - x[0]) / period
    d[-1] = (x[-1] - x[-2]) / period
    return d


def imu_samples(poses, stream: dict, gen, period: float = SCAN_PERIOD):
    """(times, rpy, acc, gyro) of an IMU riding the poses ``poses`` (n,4,4,
    world from sensor, pose k at time k * ``period``), sampled at
    ``stream["rate_hz"]`` from time 0 to the last pose: the knots' world
    acceleration by central differences of the positions, twice, and
    their body rate log(R_k^T R_k+1) / period (the last knot keeps the one
    before); each sample between knots k and k+1 at the fraction f of the
    way, its attitude R_k exp(f log(R_k^T R_k+1)), its acceleration and
    rate linear in f; then Gaussian noise of ``stream["noise_rpy"]``,
    ``["noise_acc"]`` and ``["noise_gyro"]`` from ``gen``, in that
    order.  Float64 tensors on the poses' device."""
    n, T, dev = poses.shape[0], period, poses.device
    R, pos = poses[:, :3, :3], poses[:, :3, 3]
    acc_w = _rate(_rate(pos, T), T)
    omega = torch.empty_like(pos)
    omega[:-1] = so3_log(R[:-1].transpose(-1, -2) @ R[1:]) / T
    omega[-1] = omega[-2]
    rate = float(stream["rate_hz"])
    m = int(math.floor((n - 1) * T * rate)) + 1
    times = torch.arange(m, dtype=poses.dtype, device=dev) / rate
    k = torch.clamp(torch.floor(times / T).long(), max=n - 2)
    f = torch.clamp(times / T - k, 0.0, 1.0)[:, None]
    R0 = R[k]
    Rt = R0 @ so3_exp(f * so3_log(R0.transpose(-1, -2) @ R[k + 1]))
    a_w = (1 - f) * acc_w[k] + f * acc_w[k + 1]
    gyro = (1 - f) * omega[k] + f * omega[k + 1]
    rpy = torch.stack([
        torch.atan2(Rt[:, 2, 1], Rt[:, 2, 2]),
        torch.asin(torch.clamp(-Rt[:, 2, 0], -1.0, 1.0)),
        torch.atan2(Rt[:, 1, 0], Rt[:, 0, 0])], -1)
    a_w[:, 2] += GRAVITY
    acc = (Rt.transpose(-1, -2) @ a_w[..., None])[..., 0]
    out = []
    for x, key in ((rpy, "noise_rpy"), (acc, "noise_acc"),
                   (gyro, "noise_gyro")):
        sd = float(stream[key])
        out.append(x + sd * torch.randn(x.shape, generator=gen,
                                        dtype=x.dtype, device=dev)
                   if sd > 0 else x)
    return (times, *out)


def imu_seed(seed: int) -> int:
    """The IMU noise seed of a stream whose range noise has ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (2 ** 63), 0x696D75])
    return int(ss.generate_state(1, np.uint64)[0] % (2 ** 62))


def stream_seeds(seed: int, streams: int) -> tuple:
    """The noise seed of each stream: the run's seed for one stream, seeds
    drawn from it for more."""
    if streams == 1:
        return (int(seed) % (2 ** 63),)
    ss = np.random.SeedSequence(int(seed) % (2 ** 63))
    return tuple(int(x) for x in ss.generate_state(streams, np.uint64)
                 % (2 ** 62))


def make_drive(lidar: dict, traffic: dict, seed: int, n: int, streams: int,
               device, imu: dict | None = None) -> Drive:
    """``n`` scans for each of ``streams`` streams, all on the mix's
    trajectory, stream s in the world of ``traffic["worlds"][s]`` (cycled)
    with its noise from ``stream_seeds``; cast on ``device`` and brought
    to the host in one array.  ``imu``: a configuration's ``imu_stream``
    block, or None for no IMU stream."""
    seeds = stream_seeds(seed, streams)
    poses = trajectory(traffic, n + 1, device)
    N = lidar["n_scan"] * lidar["horizon_scan"]
    scans = np.empty((n, streams, N, 3), np.float32)
    valids = np.empty((n, streams, N), np.bool_)
    w = traffic["world"]
    worlds = traffic["worlds"]
    for s, ns in enumerate(seeds):
        boxes, cyls = world_arrays(worlds[s % len(worlds)], w["extent"],
                                   w["n_boxes"], w["n_cylinders"])
        pts, valid = cast(lidar, poses, ns, traffic["noise"],
                          torch.as_tensor(boxes, device=device),
                          torch.as_tensor(cyls, device=device))
        scans[:, s] = pts.cpu().numpy()
        valids[:, s] = valid.cpu().numpy()
        del pts, valid
    if imu is None:
        return Drive(scans, valids, seeds)
    chans = []
    for ns in seeds:
        gen = torch.Generator(device=poses.device)
        gen.manual_seed(imu_seed(ns))
        times, *xs = imu_samples(poses, imu, gen)
        chans.append(torch.stack(xs))                      # (3, M, 3)
    chans = torch.stack(chans, 2).to(torch.float32).cpu().numpy()
    times = times.cpu().numpy()
    ends = np.searchsorted(times, (np.arange(n) + 1) * SCAN_PERIOD + 1e-9,
                           side="right")
    return Drive(scans, valids, seeds, Imu(times, *chans, ends))
