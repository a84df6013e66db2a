"""Scan Context descriptors (the part of
``sc_lego_loam_tpu/models/scan_context.py`` the mapping step runs; reference
Scancontext.cpp:151-211).  Retrieval belongs to loop closure and is not
ported yet."""

from __future__ import annotations

from typing import NamedTuple

import torch

from sc_lego_loam_tpu.config import PipelineConfig, ScanContextConfig

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
    desc = torch.full((R * S,), -_BIG, device=points.device)
    desc.scatter_reduce_(0, flat, val, "amax")
    desc = torch.where(desc <= -_BIG * 0.5, 0.0, desc)
    return desc.reshape(R, S)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Row means (makeRingkeyFromScancontext, Scancontext.cpp:198-211)."""
    return desc.mean(-1)


def append(bank: DescriptorBank, desc: torch.Tensor, max_k: int,
           should: torch.Tensor) -> DescriptorBank:
    """Guarded append IN PLACE, mirroring mapping.insert_keyframe: the
    descriptor is always written at slot ``count`` and ``should`` gates only
    the count bump; a full bank rewrites its last slot and drops it."""
    room = bank.count < max_k
    i = torch.clamp(bank.count.to(torch.int64), max=max_k - 1).reshape(1)
    bank.desc.index_copy_(
        0, i, torch.where(room, desc, bank.desc[i][0])[None])
    bank.ringkey.index_copy_(
        0, i, torch.where(room, ring_key(desc), bank.ringkey[i][0])[None])
    return bank._replace(count=bank.count + (should & room).to(torch.int32))
