"""Hash voxel downsampling (port of the two hot-path functions of
``sc_lego_loam_tpu/ops/voxel.py``; replaces pcl::VoxelGrid).

The voxel hash multiplies int32 voxel coordinates by large primes and
relies on int32 wraparound.  Here the products are taken in int64: the
bucket is the hash's low ``table_bits`` bits, and the low bits of a
product and of an XOR are the same with or without the wrap, so the
buckets equal the JAX package's exactly.
"""

from __future__ import annotations

import torch

from .compact import compact_indices


def _bucket(points: torch.Tensor, mask: torch.Tensor, leaf: float,
            table_bits: int) -> torch.Tensor:
    v = torch.floor(points / leaf).to(torch.int32).to(torch.int64)
    h = (v[:, 0] * 73856093) ^ (v[:, 1] * 19349669) ^ (v[:, 2] * 83492791)
    b = h & ((1 << table_bits) - 1)
    return torch.where(mask, b, torch.zeros_like(b))


def voxel_downsample_hash(points: torch.Tensor, mask: torch.Tensor,
                          leaf: float, out_pad: int, table_bits: int = 16):
    """Hash-bucket centroid voxel downsample (sort-free).  Hash collisions
    merge distant voxels, which the hot-path consumers tolerate.  The
    float scatter-adds sum in a run-dependent order on the card.
    Returns (points (out_pad,3), mask (out_pad,))."""
    T = 1 << table_bits
    bucket = _bucket(points, mask, leaf, table_bits)
    w = mask.to(points.dtype)
    sums = torch.zeros((T, 3), dtype=points.dtype,
                       device=points.device).index_add(
        0, bucket, points * w[:, None])
    cnts = torch.zeros(T, dtype=points.dtype,
                       device=points.device).index_add(0, bucket, w)
    idx, ok = compact_indices(cnts > 0, out_pad)
    centroid = sums[idx] / torch.clamp(cnts[idx], min=1.0)[:, None]
    return torch.where(ok[:, None], centroid, 0.0), ok


def voxel_decimate(points: torch.Tensor, mask: torch.Tensor, leaf: float,
                   out_pad: int, table_bits: int = 18,
                   return_indices: bool = False):
    """O(n) voxel decimation: ONE representative point per voxel (the
    lowest-index point of its hash bucket, by scatter-min).  Returns
    (points (out_pad,3), mask (out_pad,)) [+ source indices (out_pad,)]."""
    n = points.shape[0]
    T = 1 << table_bits
    bucket = _bucket(points, mask, leaf, table_bits)
    idx = torch.where(mask, torch.arange(n, device=points.device), n)
    winner = torch.full((T,), n, dtype=torch.int64,
                        device=points.device).scatter_reduce(
        0, bucket, idx, "amin")
    sel, ok = compact_indices(winner < n, out_pad)
    out_idx = torch.clamp(winner[sel], 0, n - 1)
    out = torch.where(ok[:, None], points[out_idx], 0.0)
    if return_indices:
        return out, ok, out_idx
    return out, ok
