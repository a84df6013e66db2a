"""Exact k-nearest-neighbor search in plain torch (counterpart of
``sc_lego_loam_tpu/ops/knn.py``; replaces pcl::KdTreeFLANN in the
reference's scan-to-map loop, mapOptmization.cpp:1283,1355).

This is the plain version of the CUDA kernel in ``ops/cuda_knn.py`` and has
the same contract, slot for slot:

- for each of the first ``qcnt`` queries, the k nearest VALID targets with
  squared distance ``d < max_sq_dist``, ascending, ties to the lower target
  index;
- distances are (q - t)^2 summed in fp32 (no norm expansion);
- empty slots (fewer than k targets in range, or query rows >= qcnt) hold
  ``sqd = max_sq_dist`` and index 0.

Queries are processed in chunks so the (chunk, T) distance block stays
bounded.  Ties are broken exactly by one int64 key per pair,
(float bits of d) << 32 | target index: non-negative float32 bit patterns
order like the floats, so ``topk`` of unique keys gives the lower index
first among equal distances.
"""

from __future__ import annotations

import torch

_NO_KEY = torch.iinfo(torch.int64).max


def knn(query: torch.Tensor, target: torch.Tensor, target_mask: torch.Tensor,
        k: int, max_sq_dist: float, qcnt: torch.Tensor | None = None,
        chunk: int = 512):
    """query (Q,3), target (T,3) + mask (T,), ``qcnt`` (1,) int32 on the
    query's device or None (all queries live).
    Returns (idx (Q,k) int64, sqd (Q,k) float32)."""
    Q, T = query.shape[0], target.shape[0]
    dev = query.device
    tidx = torch.arange(T, dtype=torch.int64, device=dev)
    live_q = torch.arange(Q, device=dev) < (Q if qcnt is None else qcnt)
    idx_out, sqd_out = [], []
    for s in range(0, Q, chunk):
        qc = query[s:s + chunk]
        d = ((qc[:, 0:1] - target[None, :, 0]) ** 2
             + (qc[:, 1:2] - target[None, :, 1]) ** 2
             + (qc[:, 2:3] - target[None, :, 2]) ** 2)
        cand = target_mask[None, :] & (d < max_sq_dist) \
            & live_q[s:s + chunk, None]
        bits = d.contiguous().view(torch.int32).to(torch.int64)
        key = torch.where(cand, (bits << 32) | tidx, _NO_KEY)
        if T < k:
            key = torch.cat([key, torch.full((key.shape[0], k - T), _NO_KEY,
                                             dtype=torch.int64, device=dev)],
                            1)
        best = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        found = best != _NO_KEY
        idx = torch.where(found, best & 0xFFFFFFFF, 0)
        sqd = torch.where(found, torch.gather(d, 1, idx), max_sq_dist)
        idx_out.append(idx)
        sqd_out.append(sqd)
    return torch.cat(idx_out), torch.cat(sqd_out)


def split_merge(query: torch.Tensor, target: torch.Tensor,
                target_mask: torch.Tensor, k: int, max_sq_dist: float,
                splits: int, qcnt: torch.Tensor | None = None):
    """The CUDA kernel's two stages in plain torch, for tests and
    ``chip_smoke.py`` only: the valid targets, in index order, are cut into
    ``splits`` contiguous ranges of ``ceil(count / splits)`` slots; each
    range gives a partial top-k (``knn`` on that range alone); the partial
    lists are merged lexicographically by (distance, slot).  Equal to
    ``knn`` in every slot, bit for bit.  Reads the valid count on the host.
    """
    Q, dev = query.shape[0], query.device
    slots = torch.nonzero(target_mask)[:, 0]          # slot -> original index
    count = slots.shape[0]
    length = -(-count // splits)
    keys = [torch.full((Q, k), _NO_KEY, dtype=torch.int64, device=dev)]
    dist = [torch.full((Q, k), max_sq_dist, dtype=torch.float32, device=dev)]
    for begin in range(0, count, max(length, 1)):
        part = target[slots[begin:begin + length]]
        idx, sqd = knn(query, part, torch.ones_like(part[:, 0], dtype=torch.bool),
                       k, max_sq_dist, qcnt)
        found = sqd < max_sq_dist                     # an empty slot reads max
        bits = sqd.contiguous().view(torch.int32).to(torch.int64)
        keys.append(torch.where(found, (bits << 32) | (begin + idx), _NO_KEY))
        dist.append(sqd)
    keys, dist = torch.cat(keys, 1), torch.cat(dist, 1)
    best, at = torch.topk(keys, k, dim=1, largest=False, sorted=True)
    found = best != _NO_KEY
    slot = torch.where(found, best & 0xFFFFFFFF, 0)
    idx = torch.where(found, slots[slot] if count else slot, 0)
    sqd = torch.where(found, torch.gather(dist, 1, at), max_sq_dist)
    return idx, sqd
