"""Front-end stage: raw cloud -> segmented cloud (port of
``sc_lego_loam_tpu/frontend.py``; the reference's imageProjection node):
projection -> ground extraction -> cluster segmentation -> per-ring
compaction."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import PipelineConfig

from .ops import compaction, ground, projection, segmentation


class FrontendOutput(NamedTuple):
    image: projection.RangeImage
    ground: torch.Tensor
    seg: segmentation.Segmentation
    cloud: compaction.SegmentedCloud
    outlier: compaction.OutlierCloud


def run(config: PipelineConfig, points: torch.Tensor,
        mask: torch.Tensor) -> FrontendOutput:
    """points: (N,3) float32 sensor frame (padded), mask: (N,) bool."""
    if config.lidar.ordered:
        img = projection.project_ordered(points, mask, config.lidar)
    else:
        img = projection.project(points, mask, config.lidar)
    g = ground.ground_mask(img, config.lidar, config.seg)
    s = segmentation.segment(img, g, config.lidar, config.seg)
    cloud, outlier = compaction.compact(img, s, g, config.lidar, config.seg)
    return FrontendOutput(image=img, ground=g, seg=s, cloud=cloud,
                          outlier=outlier)
