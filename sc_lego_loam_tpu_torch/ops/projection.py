"""Range-image projection (port of ``sc_lego_loam_tpu/ops/projection.py``;
reference imageProjection.cpp:199-257).

The whole cloud is projected with one vectorized row/col computation and
one scatter-min of a packed (quantized range, point index) key per pixel:
the nearest return wins, ties go to the lower point index.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import LidarConfig


class RangeImage(NamedTuple):
    """Pixelized scan. All tensors are (H, W) or (H, W, 3)."""

    xyz: torch.Tensor       # point coords in sensor frame
    rng: torch.Tensor       # range (m); 0 where no return
    valid: torch.Tensor     # bool: pixel has a return
    rel_time: torch.Tensor  # intra-scan relative time in [0,1)


def project_ordered(points: torch.Tensor, mask: torch.Tensor,
                    lidar: LidarConfig) -> RangeImage:
    """Beam-ordered fast path: point i IS pixel (i//W, i%W)."""
    H, W = lidar.n_scan, lidar.horizon_scan
    xyz = points.reshape(H, W, 3)
    r = torch.linalg.vector_norm(xyz, dim=-1)
    valid = mask.reshape(H, W) & (r > lidar.min_range) & (r < lidar.max_range)
    rel = (torch.arange(W, dtype=torch.float32, device=points.device)
           / W)[None, :].expand(H, W)
    zero = torch.zeros_like(r)
    return RangeImage(xyz=torch.where(valid[..., None], xyz, 0.0),
                      rng=torch.where(valid, r, zero), valid=valid,
                      rel_time=torch.where(valid, rel, zero))


def project(points: torch.Tensor, mask: torch.Tensor,
            lidar: LidarConfig) -> RangeImage:
    """Project a padded unordered cloud into an (n_scan, horizon) image.

    points: (N,3) float32 sensor frame, mask: (N,) bool.  The first and
    last VALID points must be the first and last captured returns: their
    azimuths anchor the intra-scan sweep that rel_time interpolates
    (findStartEndAngle, iP.cpp:199-209)."""
    H, W = lidar.n_scan, lidar.horizon_scan
    dev = points.device
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = torch.sqrt(x * x + y * y + z * z)
    ok = mask & (r > lidar.min_range) & (r < lidar.max_range)

    vert_deg = torch.rad2deg(torch.atan2(z, torch.sqrt(x * x + y * y)))
    row = torch.round((vert_deg + lidar.ang_bottom) / lidar.ang_res_y
                      ).to(torch.int32)
    ok &= (row >= 0) & (row < H)

    azim = torch.atan2(y, x)                      # (-pi, pi]
    colf = azim / lidar.ang_res_x_rad
    col = torch.remainder(torch.round(colf).to(torch.int32), W)

    n = points.shape[0]
    if n > (1 << 16):
        raise ValueError(f"pack assumes <=65536 points per scan, got {n}")
    flat = torch.where(ok, row * W + col, 0).to(torch.int64)
    rq = torch.clamp((r * 8.0).to(torch.int32), 0, (1 << 14) - 2)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    SENT = (1 << 30) - 1
    key = torch.where(ok, (rq << 16) | idx, SENT)
    packed = torch.full((H * W,), SENT, dtype=torch.int32,
                        device=dev).scatter_reduce(0, flat, key, "amin")
    valid = packed < SENT
    win = torch.clamp(packed & 0xFFFF, 0, n - 1).to(torch.int64)
    pts_w = points[win]
    rngm = torch.where(valid, torch.linalg.vector_norm(pts_w, dim=-1),
                       0.0).reshape(H, W)
    xyz = torch.where(valid[:, None], pts_w, 0.0).reshape(H, W, 3)

    # Intra-scan relative time over the scan's actual azimuth span.  The
    # device-side positions index as 1-element tensors (a 0-d tensor index
    # would be read back to the host).
    first_i = torch.argmax(ok.to(torch.int32)).reshape(1)
    last_i = n - 1 - torch.argmax(ok.flip(0).to(torch.int32)).reshape(1)
    a0 = azim[first_i]
    a1 = azim[last_i]
    two_pi = 2.0 * math.pi          # a Python scalar: rounds to fp32 in use
    span = a1 + two_pi - a0
    span = torch.where(span > 3.0 * math.pi, span - two_pi, span)
    span = torch.where(span < math.pi, span + two_pi, span)
    rel_pts = torch.remainder(azim - a0, two_pi) / span
    rel = torch.where(valid, rel_pts[win], 0.0).reshape(H, W)
    return RangeImage(xyz=xyz, rng=rngm, valid=valid.reshape(H, W),
                      rel_time=rel)
