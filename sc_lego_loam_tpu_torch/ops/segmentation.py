"""Cluster segmentation (port of ``sc_lego_loam_tpu/ops/segmentation.py``;
reference imageProjection.cpp:312-460).

Iterative min-label propagation: every active pixel starts with its own
flat index, and each round runs four directional segmented min-scans
(left, right with horizontal wrap; down, up) so a label flows along every
run of angle-connected neighbours.  The segmented min-scan is one
``cummin`` over keys offset by a segment id (``_seg_cummin``) in place of
the JAX package's ``lax.associative_scan``; min is exact, so the labels
are identical.  Component statistics then apply the reference's validity
rule (>=30 px, or >=5 px spanning >=3 rows).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import LidarConfig, SegmentationConfig

from .projection import RangeImage


class Segmentation(NamedTuple):
    label: torch.Tensor      # (H,W) int32 component root index; -1 = none
    is_cluster: torch.Tensor  # (H,W) bool: valid segment member
    is_outlier: torch.Tensor  # (H,W) bool: failed-segment pixel


def _pair_connected(d_a, d_b, valid_a, valid_b, alpha, theta_rad):
    """Angle criterion for one neighbor direction (iP.cpp:411-423)."""
    d1 = torch.maximum(d_a, d_b)
    d2 = torch.minimum(d_a, d_b)
    ang = torch.atan2(d2 * math.sin(alpha), d1 - d2 * math.cos(alpha))
    return valid_a & valid_b & (ang > theta_rad)


def _seg_cummin(vals, starts, dim):
    """Forward segmented running min along ``dim``: out[i] = min(vals[j])
    over j <= i with no segment start in (j, i].  ``starts`` (bool) marks
    positions that begin a new segment.  Keys are offset by -segment_id *
    BIG, so every earlier segment's keys are larger than any key of the
    current one and one plain cummin respects the boundaries."""
    big = 1 << 32                                    # > any label
    sid = torch.cumsum(starts.to(torch.int64), dim)
    key = vals.to(torch.int64) - sid * big
    return (torch.cummin(key, dim).values + sid * big).to(vals.dtype)


def _seg_cummin_rev(vals, starts, dim):
    """Reverse scan, as ``lax.associative_scan(reverse=True)``: flip, scan
    forward, flip back."""
    return _seg_cummin(vals.flip(dim), starts.flip(dim), dim).flip(dim)


def segment(img: RangeImage, ground: torch.Tensor, lidar: LidarConfig,
            seg: SegmentationConfig) -> Segmentation:
    H, W = img.rng.shape
    dev = img.rng.device
    theta = math.radians(seg.segment_theta_deg)
    ax = lidar.ang_res_x_rad
    ay = lidar.ang_res_y_rad

    active = img.valid & ~ground
    r = img.rng

    # Neighbor connectivity per direction; horizontal wraps.
    conn_r = _pair_connected(r, torch.roll(r, -1, 1), active,
                             torch.roll(active, -1, 1), ax, theta)
    conn_l = torch.roll(conn_r, 1, 1)
    zrow = torch.zeros((1, W), dtype=r.dtype, device=dev)
    frow = torch.zeros((1, W), dtype=torch.bool, device=dev)
    up = torch.cat([r[1:], zrow], 0)
    up_ok = torch.cat([active[1:], frow], 0)
    conn_u = _pair_connected(r, up, active, up_ok, ay, theta)
    conn_d = torch.cat([frow, conn_u[:-1]], 0)

    n = H * W
    flat_idx = torch.arange(n, dtype=torch.int32, device=dev).reshape(H, W)
    init2d = torch.where(active, flat_idx, n)

    # Segment starts: a pixel begins a new run where it is NOT connected to
    # its predecessor in the scan direction.  Rows wrap by width doubling.
    bl = torch.cat([~conn_l, ~conn_l], 1)
    br = torch.cat([~conn_r, ~conn_r], 1)
    bd = ~conn_d
    bu = ~conn_u

    lab = init2d
    for _ in range(seg.max_label_rounds):
        lab = _seg_cummin(torch.cat([lab, lab], 1), bl, 1)[:, W:]
        lab = _seg_cummin_rev(torch.cat([lab, lab], 1), br, 1)[:, :W]
        lab = _seg_cummin(lab, bd, 0)
        lab = _seg_cummin_rev(lab, bu, 0)
        lab = torch.where(active, lab, n)
    label = lab.reshape(-1)
    init = init2d.reshape(-1)

    # Component statistics: count and distinct-row count per root label.
    rows = torch.arange(H, device=dev).repeat_interleave(W)
    activef = init < n
    safe_label = torch.where(activef, label, 0).to(torch.int64)
    counts = torch.zeros(n, dtype=torch.int32, device=dev).scatter_add(
        0, safe_label, activef.to(torch.int32))
    lines = _distinct_rows(safe_label, rows, activef, n, H)

    cnt_pix = counts[safe_label]
    cnt_lines = lines[safe_label]
    ok = (cnt_pix >= seg.min_cluster_size) | (
        (cnt_pix >= seg.valid_point_num) & (cnt_lines >= seg.valid_line_num))
    is_cluster = activef & ok
    is_outlier = activef & ~ok
    out_label = torch.where(is_cluster, label, -1)
    return Segmentation(label=out_label.reshape(H, W),
                        is_cluster=is_cluster.reshape(H, W),
                        is_outlier=is_outlier.reshape(H, W))


def _distinct_rows(safe_label, rows, active, n, H):
    """lines[l] = number of distinct rows among active pixels with label l,
    from an exact (n*H,) presence table (the last slot absorbs inactive
    pixels)."""
    key = torch.where(active, safe_label * H + rows, n * H)
    presence = torch.zeros(n * H + 1, dtype=torch.int32,
                           device=safe_label.device).index_fill(0, key, 1)
    return presence[:n * H].reshape(n, H).sum(-1, dtype=torch.int32)
