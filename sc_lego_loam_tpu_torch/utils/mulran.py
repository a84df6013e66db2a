"""MulRan dataset loader (DCC / KAIST / Riverside sequences); numpy only,
the port's own copy of ``sc_lego_loam_tpu/utils/mulran.py``.

The reference consumes MulRan via ROS bags; this loader reads the raw
MulRan layout directly:

  <seq>/sensor_data/Ouster/<timestamp_ns>.bin   float32 x,y,z,intensity
  <seq>/global_pose.csv                         timestamp_ns, 4x3 pose rows

Scans are padded/truncated to the fixed max_points contract.  Everything is
gated on the dataset being present (no dataset ships with this repo; the
synthetic generator in utils/synthetic.py is the default fixture).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from ..config import LidarConfig


def available(root: str) -> bool:
    return os.path.isdir(os.path.join(root, "sensor_data", "Ouster"))


def scan_files(root: str) -> list[str]:
    d = os.path.join(root, "sensor_data", "Ouster")
    return sorted(
        os.path.join(d, f) for f in os.listdir(d) if f.endswith(".bin"))


def load_scan(path: str, lidar: LidarConfig):
    """Returns (points (max_points,3) float32, mask (max_points,) bool)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    pts = raw[:, :3]
    n = min(len(pts), lidar.max_points)
    out = np.zeros((lidar.max_points, 3), np.float32)
    mask = np.zeros((lidar.max_points,), bool)
    out[:n] = pts[:n]
    mask[:n] = np.linalg.norm(pts[:n], axis=1) > 1e-3
    return out, mask


def iter_scans(root: str, lidar: LidarConfig,
               limit: int | None = None) -> Iterator[tuple]:
    """Yields (timestamp_s, points, mask)."""
    files = scan_files(root)
    if limit is not None:
        files = files[:limit]
    for f in files:
        ts = int(os.path.splitext(os.path.basename(f))[0]) * 1e-9
        pts, mask = load_scan(f, lidar)
        yield ts, pts, mask


def load_gt_poses(root: str) -> tuple[np.ndarray, np.ndarray]:
    """global_pose.csv -> (timestamps_s (N,), poses (N,4,4))."""
    path = os.path.join(root, "global_pose.csv")
    rows = np.loadtxt(path, delimiter=",")
    ts = rows[:, 0] * 1e-9
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :4] = rows[:, 1:13].reshape(-1, 3, 4)
    return ts, poses.astype(np.float32)
