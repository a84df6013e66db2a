"""Sharded Scan Context retrieval (port of
``sc_lego_loam_tpu/parallel/retrieval.py``).

The descriptor bank's K axis is split over the mesh's 'kf' axis in
contiguous blocks (``parallel.mesh``).  Each rank scores the query against
its block at every column shift (``scan_context.distance_all_shifts``),
keeps its best (distance, index, shift), and one ``exchange`` (an
all-reduce of a slot vector) hands every rank all the winners; the argmin
takes the first minimum, so the lowest shard and then the lowest row win a
tie, as in the JAX package and in the unsharded ``scan_context.detect``.
O(K/n) work a rank and one collective of 3n numbers.
"""

from __future__ import annotations

import math

import torch

from ..config import PipelineConfig
from ..models import scan_context
from . import mesh as mesh_mod

_BIG = 1e9


def _local_best(query, desc_shard, base_idx: int, exclude_lo):
    """Best match within one bank block.  Returns (dist, idx, shift), each
    () on the device."""
    d = scan_context.distance_all_shifts(query, desc_shard)   # (Ks,S)
    dist_k, shift_k = d.min(-1)
    ids = base_idx + torch.arange(desc_shard.shape[0], device=d.device)
    dist_k = torch.where(ids < exclude_lo, dist_k, _BIG)
    b = torch.argmin(dist_k).reshape(1)
    return dist_k[b][0], ids[b][0], shift_k[b][0]


def detect_sharded(config: PipelineConfig, mesh, bank_desc_local, count,
                   query_desc):
    """Sharded counterpart of ``models.scan_context.detect``.

    ``mesh``: a ``DeviceMesh`` with a 'kf' axis, or its ``mesh.Shard``;
    ``bank_desc_local``: this rank's (K/n, R, S) block of the bank;
    ``count``: the bank's () count (replicated).  Returns
    (best_idx () int64 or -1, best_dist, yaw), the same on every rank."""
    sc = config.sc
    shard = mesh_mod.bank_sharding(mesh)
    lo, _ = shard.block(bank_desc_local.shape[0] * shard.size)
    dist, idx, shift = _local_best(query_desc, bank_desc_local, lo,
                                   count - sc.exclude_recent)
    # One collective: the winners of every shard, stacked by shard.
    won = mesh_mod.exchange(torch.stack(
        [dist.to(torch.float64), idx.to(torch.float64),
         shift.to(torch.float64)]), shard)                       # (n,3)
    b = torch.argmin(won[:, 0]).reshape(1)     # first minimum: lowest shard
    best = won[b][0]
    best_dist = best[0].to(dist.dtype)
    ok = best_dist < sc.dist_threshold
    yaw = best[2].to(dist.dtype) * (2.0 * math.pi / sc.num_sector)
    return (torch.where(ok, best[1].to(torch.int64), -1), best_dist, yaw)
