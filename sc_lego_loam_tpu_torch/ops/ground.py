"""Ground extraction (port of ``sc_lego_loam_tpu/ops/ground.py``;
reference imageProjection.cpp:260-310)."""

from __future__ import annotations

import torch

from ..config import LidarConfig, SegmentationConfig

from .projection import RangeImage


def ground_mask(img: RangeImage, lidar: LidarConfig,
                seg: SegmentationConfig) -> torch.Tensor:
    """(H, W) bool: pixel is ground.  Both pixels of a qualifying vertical
    pair below ``ground_scan_ind`` are marked (imageProjection.cpp:267-291)."""
    H, W = img.rng.shape
    diff = img.xyz[1:] - img.xyz[:-1]
    angle = torch.rad2deg(torch.atan2(
        diff[..., 2], torch.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)))
    pair_ok = (img.valid[:-1] & img.valid[1:] &
               ((angle - lidar.mount_angle).abs() <= seg.ground_angle_deg))
    row_ok = (torch.arange(H - 1, device=angle.device)
              < lidar.ground_scan_ind)[:, None]
    pair_ok &= row_ok
    g = torch.zeros((H, W), dtype=torch.bool, device=angle.device)
    g[:-1] = pair_ok
    g[1:] |= pair_ok
    return g & img.valid
