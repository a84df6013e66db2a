"""Voxel-grid downsampling (port of ``sc_lego_loam_tpu/ops/voxel.py``;
replaces pcl::VoxelGrid).

Two hash-bucket filters serve the engine (``voxel_downsample_hash`` for
the scan, ``voxel_decimate`` for submaps); ``voxel_downsample`` is the
exact, sort-based centroid filter (no engine path calls it, as in the JAX
package): points are sorted lexicographically by integer voxel
coordinates with three stable sorts, groups start where consecutive keys
differ, and each group's centroid is a segment mean, voxel order by
coordinates.

The voxel hash multiplies int32 voxel coordinates by large primes and
relies on int32 wraparound.  Here the products are taken in int64: the
bucket is the hash's low ``table_bits`` bits, and the low bits of a
product and of an XOR are the same with or without the wrap, so the
buckets equal the JAX package's exactly.
"""

from __future__ import annotations

import torch

from .compact import compact_indices

_SENT = 2**30


def voxel_keys(points: torch.Tensor, mask: torch.Tensor,
               leaf: float) -> torch.Tensor:
    """Integer voxel coords (N,3) int32, invalid points at a sentinel."""
    v = torch.floor(points / leaf).to(torch.int32)
    return torch.where(mask[:, None], v, _SENT)


def _lex_order(v: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic argsort of (N,3) int rows (x major)."""
    order = torch.sort(v[:, 2], stable=True).indices
    order = order[torch.sort(v[order, 1], stable=True).indices]
    return order[torch.sort(v[order, 0], stable=True).indices]


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, leaf: float,
                     out_pad: int, extras: torch.Tensor | None = None):
    """Centroid-downsample a padded cloud, exactly (no hash).

    points (N,3), mask (N,), extras optional (N,E) channels averaged
    alongside.  Returns (points (min(out_pad, N),3), mask, extras or None);
    voxels past ``out_pad`` in coordinate order are dropped."""
    v = voxel_keys(points, mask, leaf)
    order = _lex_order(v)
    vs, ps, ms = v[order], points[order], mask[order]
    new_group = (vs != torch.roll(vs, 1, 0)).any(1)
    new_group[0] = True
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
    n = points.shape[0]
    w = ms.to(points.dtype)
    gsum = torch.zeros((n, 3), dtype=points.dtype,
                       device=points.device).index_add(0, gid,
                                                       ps * w[:, None])
    gcnt = torch.zeros(n, dtype=points.dtype,
                       device=points.device).index_add(0, gid, w)
    out_mask = gcnt[:out_pad] > 0
    out = gsum[:out_pad] / torch.clamp(gcnt[:out_pad], min=1.0)[:, None]
    out = torch.where(out_mask[:, None], out, 0.0)
    if extras is None:
        return out, out_mask, None
    esum = torch.zeros((n, extras.shape[1]), dtype=extras.dtype,
                       device=extras.device).index_add(
        0, gid, extras[order] * w[:, None])
    ex = esum[:out_pad] / torch.clamp(gcnt[:out_pad], min=1.0)[:, None]
    return out, out_mask, torch.where(out_mask[:, None], ex, 0.0)


def downsample_count(mask_out: torch.Tensor) -> torch.Tensor:
    return mask_out.sum().to(torch.int32)


def _bucket(points: torch.Tensor, mask: torch.Tensor, leaf: float,
            table_bits: int) -> torch.Tensor:
    v = torch.floor(points / leaf).to(torch.int32).to(torch.int64)
    h = (v[:, 0] * 73856093) ^ (v[:, 1] * 19349669) ^ (v[:, 2] * 83492791)
    b = h & ((1 << table_bits) - 1)
    return torch.where(mask, b, torch.zeros_like(b))


def voxel_downsample_hash(points: torch.Tensor, mask: torch.Tensor,
                          leaf: float, out_pad: int, table_bits: int = 16):
    """Hash-bucket centroid voxel downsample (sort-free).  Hash collisions
    merge distant voxels, which the hot-path consumers tolerate.
    Returns (points (out_pad,3), mask (out_pad,)).

    The bucket sums are an accumulating ``index_put``: on the card it sorts
    the bucket indices stably and adds each bucket's points in their index
    order, as the CPU (and the JAX package's scatter-add there) does, so
    the sums have the same bits run to run and on either device.  A float
    ``index_add`` on the card adds in the order its atomics land."""
    T = 1 << table_bits
    bucket = _bucket(points, mask, leaf, table_bits)
    w = mask.to(points.dtype)
    sums = torch.zeros((T, 3), dtype=points.dtype,
                       device=points.device).index_put(
        (bucket,), points * w[:, None], accumulate=True)
    cnts = torch.zeros(T, dtype=points.dtype,
                       device=points.device).index_put(
        (bucket,), w, accumulate=True)
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
