"""Segmented-cloud assembly (port of ``sc_lego_loam_tpu/ops/compaction.py``;
reference imageProjection.cpp:312-368).

The (H, W) grid shape is kept and each row is compacted in place: kept
pixels move to the front of their row in column order (one row-wise cumsum
for destinations plus one scatter per channel), with a per-ring count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import LidarConfig, SegmentationConfig

from .projection import RangeImage
from .segmentation import Segmentation


class SegmentedCloud(NamedTuple):
    """Per-ring compacted segmented cloud. All (H, W) unless noted."""

    xyz: torch.Tensor       # (H, W, 3)
    rng: torch.Tensor       # (H, W) range
    col: torch.Tensor       # (H, W) original column index
    ground: torch.Tensor    # (H, W) bool
    valid: torch.Tensor     # (H, W) bool — position < per-ring count
    count: torch.Tensor     # (H,) int32 kept points per ring
    rel_time: torch.Tensor  # (H, W) intra-scan relative time


class OutlierCloud(NamedTuple):
    xyz: torch.Tensor       # (H, W, 3) row-compacted
    valid: torch.Tensor     # (H, W)
    count: torch.Tensor     # (H,)
    rel_time: torch.Tensor  # (H, W)


def compact(img: RangeImage, seg_res: Segmentation, ground: torch.Tensor,
            lidar: LidarConfig, seg: SegmentationConfig
            ) -> tuple[SegmentedCloud, OutlierCloud]:
    H, W = img.rng.shape
    dev = img.rng.device
    cols = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    rows = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(H, W)

    # Keep rule (iP.cpp:326-351): cluster points always; ground points only
    # every 5th column (plus the ring edges).
    ground_keep = ground & (
        (cols % seg.ground_keep_stride == 0) | (cols <= 5) | (cols >= W - 5))
    keep = seg_res.is_cluster | ground_keep
    # Outliers (iP.cpp:328-335): failed-segment pixels above the ground
    # rows, every 5th column.
    out_keep = seg_res.is_outlier & (rows > lidar.ground_scan_ind) & (
        cols % seg.outlier_keep_stride == 0)

    segmented = _row_compact(img, keep, ground, cols)
    outlier = _row_compact(img, out_keep, ground, cols)
    return segmented, OutlierCloud(xyz=outlier.xyz, valid=outlier.valid,
                                   count=outlier.count,
                                   rel_time=outlier.rel_time)


def _row_compact(img: RangeImage, keep: torch.Tensor, ground: torch.Tensor,
                 cols: torch.Tensor) -> SegmentedCloud:
    """Kept pixels to the front of their row, preserving column order."""
    H, W = keep.shape
    dev = keep.device
    pos = torch.cumsum(keep.to(torch.int64), 1) - 1
    rows = torch.arange(H, dtype=torch.int64, device=dev)[:, None]
    dest = torch.where(keep, rows * W + pos, H * W).reshape(-1)  # junk slot

    def scat(a):
        a2 = a.reshape(H * W, -1)
        table = torch.zeros((H * W + 1, a2.shape[1]), dtype=a2.dtype,
                            device=dev)
        table.index_put_((dest,), a2)
        return table[:H * W].reshape((H, W) + a.shape[2:])

    count = keep.sum(-1, dtype=torch.int32)
    posw = torch.arange(W, device=dev)[None, :]
    return SegmentedCloud(
        xyz=scat(img.xyz),
        rng=scat(img.rng),
        col=scat(cols),
        ground=scat(ground),
        valid=posw < count[:, None],
        count=count,
        rel_time=scat(img.rel_time),
    )
