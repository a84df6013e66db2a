"""Scan Context place recognition (port of
``sc_lego_loam_tpu/models/scan_context.py``; reference Scancontext.cpp).

Descriptor (makeScancontext, Scancontext.cpp:151-195): a 20x60 polar
max-height image of the cloud, +2 m lidar-height offset, 80 m radius, as
one scatter-max.  Retrieval (detectLoopClosureID, Scancontext.cpp:247-338):
the reference kd-trees ring keys for 10 candidates and then scans column
shifts per candidate; here, as in the JAX package, ALL keyframes x ALL
column shifts come from one matrix product of the rolled query copies with
the column-normalized bank, an exact minimum over the whole bank."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import PipelineConfig, ScanContextConfig

_BIG = 1e9


class DescriptorBank(NamedTuple):
    """Fixed-capacity descriptor store."""

    desc: torch.Tensor      # (K, R, S) scan contexts
    ringkey: torch.Tensor   # (K, R) row means (rotation invariant)
    count: torch.Tensor     # () int32


def init_bank(config: PipelineConfig, device) -> DescriptorBank:
    sc = config.sc
    K = config.cap.max_keyframes
    return DescriptorBank(
        desc=torch.zeros((K, sc.num_ring, sc.num_sector), device=device),
        ringkey=torch.zeros((K, sc.num_ring), device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


def make_descriptor(points: torch.Tensor, mask: torch.Tensor,
                    sc: ScanContextConfig) -> torch.Tensor:
    """(N,3) sensor-frame cloud -> (R,S) scan context: a scatter-max of
    z + lidar_height into polar bins; empty bins stay 0."""
    R, S = sc.num_ring, sc.num_sector
    if points.shape[0] > sc.max_input_points:
        stride = -(-points.shape[0] // sc.max_input_points)
        points = points[::stride]
        mask = mask[::stride]
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    rho = torch.sqrt(x * x + y * y)
    theta = torch.remainder(torch.rad2deg(torch.atan2(y, x)), 360.0)
    ok = mask & (rho < sc.max_radius) & (rho > 1e-3)
    ring = torch.clamp((rho / (sc.max_radius / R)).to(torch.int32), 0, R - 1)
    sector = torch.clamp((theta / (360.0 / S)).to(torch.int32), 0, S - 1)
    flat = torch.where(ok, ring * S + sector, 0).to(torch.int64)
    val = torch.where(ok, z + sc.lidar_height, -_BIG)
    desc = torch.full((R * S,), -_BIG, device=points.device
                      ).scatter_reduce(0, flat, val, "amax")
    desc = torch.where(desc <= -_BIG * 0.5, 0.0, desc)
    return desc.reshape(R, S)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Row means (makeRingkeyFromScancontext, Scancontext.cpp:198-211)."""
    return desc.mean(-1)


def sector_key(desc: torch.Tensor) -> torch.Tensor:
    """Column means (makeSectorkeyFromScancontext, Scancontext.cpp:214-227)."""
    return desc.mean(-2)


def append_rows(bank: DescriptorBank, desc: torch.Tensor, max_k: int):
    """What ``append`` writes, without writing it: (slot (1,), room,
    desc row, ring-key row); runs under ``torch.func.vmap``."""
    room = bank.count < max_k
    i = torch.clamp(bank.count.to(torch.int64), max=max_k - 1).reshape(1)
    return (i, room, torch.where(room, desc, bank.desc[i][0]),
            torch.where(room, ring_key(desc), bank.ringkey[i][0]))


def append(bank: DescriptorBank, desc: torch.Tensor, max_k: int,
           should: torch.Tensor) -> DescriptorBank:
    """Guarded append IN PLACE, mirroring mapping.insert_keyframe: the
    descriptor is always written at slot ``count`` and ``should`` gates only
    the count bump; a full bank rewrites its last slot and drops it."""
    i, room, desc_row, key_row = append_rows(bank, desc, max_k)
    bank.desc.index_copy_(0, i, desc_row[None])
    bank.ringkey.index_copy_(0, i, key_row[None])
    return bank._replace(count=bank.count + (should & room).to(torch.int32))


def distance_all_shifts(query: torch.Tensor, bank_desc: torch.Tensor):
    """Column-wise cosine distance between ``query`` (R,S) and every bank
    descriptor at every circular column shift.  Returns (K,S) distances;
    columns with zero norm in either descriptor are left out of the mean
    (distDirectSC, Scancontext.cpp:69-90).

    Shift s compares query column (m+s) % S with bank column m, i.e. it is
    the column roll of the BANK descriptor that best reproduces the query
    (circshift convention, Scancontext.cpp:39-59).  All S rolled copies of
    the query are contracted against the whole bank in one
    (K, R*S) x (R*S, S) product."""
    K, R, S = bank_desc.shape
    dev = query.device
    qn = torch.linalg.vector_norm(query, dim=0)            # (S,)
    bn = torch.linalg.vector_norm(bank_desc, dim=1)        # (K,S)
    q_unit = query / torch.clamp(qn, min=1e-12)[None, :]
    b_unit = bank_desc / torch.clamp(bn, min=1e-12)[:, None, :]
    q_ok = (qn > 0).to(query.dtype)
    b_ok = (bn > 0).to(query.dtype)

    # Qs[s, r, m] = q_unit[r, (m+s) % S], invalid columns zeroed.
    ar = torch.arange(S, device=dev)
    roll_idx = (ar[None, :] + ar[:, None]) % S             # (S_shift, S_m)
    Qs = (q_unit * q_ok[None, :])[:, roll_idx].transpose(0, 1)  # (S,R,S)
    q_ok_s = q_ok[roll_idx]                                # (S_shift, S_m)

    sim_sum = b_unit.reshape(K, R * S) @ Qs.reshape(S, R * S).T    # (K,S)
    cnt_sum = b_ok @ q_ok_s.T           # mutually valid columns per shift
    dist = 1.0 - sim_sum / torch.clamp(cnt_sum, min=1.0)
    return torch.where(cnt_sum > 0, dist, _BIG)


def detect(config: PipelineConfig, bank: DescriptorBank,
           query_desc: torch.Tensor):
    """Loop retrieval.  Returns (best_idx () int64, best_dist, best_yaw_rad);
    best_idx = -1 when no candidate beats SC_DIST_THRES.  The most recent
    ``exclude_recent`` keyframes are excluded (Scancontext.cpp:257-261).
    The yaw is the aligning rotation, shift * sector angle
    (Scancontext.cpp:333-336)."""
    sc = config.sc
    d = distance_all_shifts(query_desc, bank.desc)         # (K,S)
    dist_k, shift_k = d.min(-1)
    K = bank.desc.shape[0]
    eligible = torch.arange(K, device=d.device) \
        < bank.count - sc.exclude_recent
    dist_k = torch.where(eligible, dist_k, _BIG)
    best = torch.argmin(dist_k).reshape(1)      # first of equal minima
    best_dist = dist_k[best][0]
    ok = best_dist < sc.dist_threshold
    yaw = shift_k[best][0].to(d.dtype) * (2.0 * math.pi / sc.num_sector)
    return torch.where(ok, best[0], -1), best_dist, yaw
