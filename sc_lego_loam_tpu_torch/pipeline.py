"""The SLAM engine, loop closure and IMU off (port of
``sc_lego_loam_tpu/pipeline.py``).

Two steps over device-resident state, as in the JAX package:

  perception_step   every scan      frontend -> de-skew -> features ->
                                    odometry -> fused pose -> trajectory
  mapping_step      >= 0.3 s apart  submap -> scan-to-map LM -> correction
                                    -> guarded keyframe + descriptor insert

The host only schedules (the mapping cadence is a wall-clock gate in the
reference, utility.h:109) and never reads a device value inside
``process_scan``; the trajectory is fetched once, by ``trajectory_array``.
State updates are in place where a buffer is large (trajectory rings,
keyframe and descriptor banks).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from sc_lego_loam_tpu.config import PipelineConfig

from . import frontend, mapping, odometry
from .models import scan_context
from .ops import features as features_op
from .ops.compact import compact_indices
from .utils import se3


def _extract(config: PipelineConfig, cloud, outlier_grid):
    """Feature extraction + outlier-list compaction.  The sparse pick sets
    are skipped when the dense-query odometry never reads them."""
    fs = features_op.extract(
        cloud, config.feat, config.cap,
        sparse_picks=not (config.odom.joint_6dof
                          and config.odom.dense_queries))
    idx, ok = compact_indices(outlier_grid.valid.reshape(-1),
                              config.cap.outlier_pad)
    out_pts = torch.where(ok[:, None], outlier_grid.xyz.reshape(-1, 3)[idx],
                          0.0)
    return fs, out_pts, ok


def _pre_deskew(config: PipelineConfig, fo, odo_state):
    """De-skew the segmented cloud AND the outlier grid into the scan-END
    frame with the carried previous twist (lidar-only branch of the JAX
    package's _pre_deskew); rel_time becomes 1."""
    if not config.odom.deskew:
        return fo
    xi0 = odo_state.motion

    def ds(grid_xyz, grid_rel, grid_valid):
        pts = odometry.deskew_with_twist(xi0, grid_xyz.reshape(-1, 3),
                                         grid_rel.reshape(-1))
        xyz = pts.reshape(grid_xyz.shape)
        return (torch.where(grid_valid[..., None], xyz, 0.0),
                grid_valid.to(grid_rel.dtype))

    cloud, outl = fo.cloud, fo.outlier
    c_xyz, c_rel = ds(cloud.xyz, cloud.rel_time, cloud.valid)
    o_xyz, o_rel = ds(outl.xyz, outl.rel_time, outl.valid)
    return fo._replace(
        cloud=cloud._replace(xyz=c_xyz, rel_time=c_rel),
        outlier=outl._replace(xyz=o_xyz, rel_time=o_rel))


class PerceptionState(NamedTuple):
    """Device state of the every-scan path."""

    odo: odometry.OdometryState
    traj: torch.Tensor         # (max_scans, 4, 4) fused poses
    odom_traj: torch.Tensor    # (max_scans, 4, 4) raw odometry poses
    traj_t: torch.Tensor       # (max_scans,)
    scan_i: torch.Tensor       # () int32


class MapperState(NamedTuple):
    """Device state of the mapping path."""

    kf: mapping.KeyframeStore
    bank: scan_context.DescriptorBank
    correction: torch.Tensor   # (4,4) map-from-odom drift correction
    pose: torch.Tensor         # (4,4) latest mapped pose
    last_kf_pose: torch.Tensor  # (4,4) pose at last keyframe insertion
    last_kf_odom: torch.Tensor  # (4,4) odometry pose at last keyframe
    kf_dropped: torch.Tensor   # () int32 — keyframes dropped at full bank


def init_perception_state(config: PipelineConfig, device) -> PerceptionState:
    n = config.cap.max_scans
    return PerceptionState(
        odo=odometry.init_state(config, device),
        traj=torch.eye(4, device=device).repeat(n, 1, 1),
        odom_traj=torch.eye(4, device=device).repeat(n, 1, 1),
        traj_t=torch.zeros(n, device=device),
        scan_i=torch.zeros((), dtype=torch.int32, device=device))


def init_mapper_state(config: PipelineConfig, device) -> MapperState:
    ms = mapping.init_state(config, device)
    return MapperState(
        kf=ms.kf, bank=scan_context.init_bank(config, device),
        correction=ms.correction, pose=ms.pose,
        last_kf_pose=ms.last_kf_pose,
        last_kf_odom=torch.eye(4, device=device),
        kf_dropped=torch.zeros((), dtype=torch.int32, device=device))


def perception_step(config: PipelineConfig, state: PerceptionState,
                    correction, points, mask, t):
    """Per-scan step: frontend -> de-skew -> features -> odometry -> fusion.
    Writes the trajectory rings in place.
    Returns (state, odom_pose, out_pts, out_mask, fused_pose)."""
    cfg = config
    fo = frontend.run(cfg, points, mask)
    fo = _pre_deskew(cfg, fo, state.odo)
    fs, out_pts, out_mask = _extract(cfg, fo.cloud, fo.outlier)
    odo, odom_pose, _ = odometry.step(cfg, state.odo, fs)

    # High-rate fusion (transformFusion.cpp:94-179) with the latest mapping
    # correction (one mapping tick stale, as in the reference).
    fused = correction @ odom_pose
    i = torch.clamp(state.scan_i.to(torch.int64),
                    max=cfg.cap.max_scans - 1).reshape(1)
    state.traj.index_copy_(0, i, fused[None])
    state.odom_traj.index_copy_(0, i, odom_pose[None])
    state.traj_t.index_copy_(0, i, t.reshape(1))
    state = state._replace(odo=odo, scan_i=state.scan_i + 1)
    return state, odom_pose, out_pts, out_mask, fused


def mapping_step(config: PipelineConfig, mst: MapperState,
                 corner_xyz, corner_mask, surf_xyz, surf_mask,
                 out_pts, out_mask, odom_pose, points, mask, t):
    """One mapping tick (reference run(), mO.cpp:1673-1708): submap ->
    scan-to-map LM -> correction -> guarded keyframe insert."""
    cfg = config
    sub_c, sub_cm, sub_s, sub_sm = mapping.build_submap(cfg, mst.kf)
    c, cm, s, sm, o, om = mapping.downsample_scan(
        cfg, corner_xyz, corner_mask, surf_xyz, surf_mask, out_pts, out_mask)

    T_guess = mst.correction @ odom_pose
    pose = mapping.scan_to_map(cfg, T_guess, c, cm, torch.cat([s, o]),
                               torch.cat([sm, om]), sub_c, sub_cm, sub_s,
                               sub_sm)
    correction = pose @ se3.mat_inv(odom_pose)

    should = mapping.should_insert_keyframe(cfg, mst.last_kf_pose, pose)
    kf, inserted = mapping.insert_keyframe(
        cfg, mst.kf, should, pose, t, c, cm, s, sm, o, om,
        odom_pose=odom_pose)
    desc = scan_context.make_descriptor(points, mask, cfg.sc)
    bank = scan_context.append(mst.bank, desc, cfg.cap.max_keyframes, should)
    return MapperState(
        kf=kf, bank=bank, correction=correction, pose=pose,
        last_kf_pose=torch.where(inserted, pose, mst.last_kf_pose),
        last_kf_odom=torch.where(inserted, odom_pose, mst.last_kf_odom),
        kf_dropped=mst.kf_dropped + (should & ~inserted).to(torch.int32))


class SlamEngine:
    """Single-sequence SLAM, loop closure and IMU off (BASELINE.json
    config 1).  ``device`` is explicit (``"cuda"`` on the card, ``"cpu"``
    for the plain versions of the kernels).  ``process_scan`` reads no
    device value; ``trajectory_array()`` fetches the run once."""

    def __init__(self, config: PipelineConfig, device):
        if config.loop.enabled:
            raise NotImplementedError(
                "loop closure is not ported yet: set loop.enabled=False")
        if config.imu.enabled:
            raise NotImplementedError(
                "the IMU path is not ported yet: set imu.enabled=False")
        # fp32 everywhere, as the JAX entry points' "highest" precision.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.device = torch.device(device)
        self.p = init_perception_state(config, self.device)
        self.m = init_mapper_state(config, self.device)
        self.last_map_time = -1e9
        self.map_ticks = 0
        self._scans_fed = 0
        self._warned_kf_cap = False

    def process_scan(self, points, mask, t: float):
        """Feed one scan (padded (N,3) + mask, numpy or tensors).  Returns
        the fused pose as a device tensor (no sync)."""
        cfg = self.config
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        # A fill kernel, not a host->device copy (which would sync).
        t_dev = torch.full((), t, dtype=torch.float32, device=self.device)

        self._scans_fed += 1
        if self._scans_fed == cfg.cap.max_scans + 1:
            warnings.warn(
                f"trajectory ring buffer full ({cfg.cap.max_scans} scans): "
                "later poses overwrite the last slot; raise "
                "CapacityConfig.max_scans", RuntimeWarning)

        self.p, odom_pose, out_pts, out_mask, fused = perception_step(
            cfg, self.p, self.m.correction, points, mask, t_dev)

        if t - self.last_map_time >= cfg.mapping.process_interval:
            self.last_map_time = t
            odo = self.p.odo
            self.m = mapping_step(
                cfg, self.m, odo.corner_last.xyz, odo.corner_last.mask,
                odo.surf_last.xyz, odo.surf_last.mask, out_pts, out_mask,
                odom_pose, points, mask, t_dev)
            self.map_ticks += 1
        # Host-side bound on the device counter: inserts <= mapping ticks.
        if not self._warned_kf_cap and \
                self.map_ticks >= cfg.cap.max_keyframes:
            warnings.warn(
                f"keyframe bank may be full ({cfg.cap.max_keyframes}): "
                "new keyframes past the cap are dropped; raise "
                "CapacityConfig.max_keyframes", RuntimeWarning)
            self._warned_kf_cap = True
        return fused

    def trajectory_array(self, retro_correct: bool = True):
        """(N,4,4) numpy trajectory so far (one fetch).  ``retro_correct``
        re-expresses every scan through its keyframe anchor
        X_k @ odom_k^-1 @ odom_i (the reference's exported key-pose path);
        ``False`` returns the as-published fused stream."""
        n = int(self.p.scan_i)
        fused = self.p.traj[:n].cpu().numpy()
        if not retro_correct or n == 0:
            return fused
        kf_n = int(self.m.kf.count)
        if kf_n == 0:
            return fused
        kf_t = self.m.kf.times[:kf_n].cpu().numpy()
        kf_pose = se3.pose6_to_mat(self.m.kf.poses6[:kf_n]).cpu().numpy()
        kf_odom = self.m.kf.odom_pose[:kf_n].cpu().numpy()
        odom = self.p.odom_traj[:n].cpu().numpy()
        t = self.p.traj_t[:n].cpu().numpy()
        k = np.searchsorted(kf_t, t + 1e-6) - 1          # last kf <= t_i
        out = fused.copy()
        ok = k >= 0
        ki = np.clip(k, 0, kf_n - 1)
        anchor = kf_pose[ki] @ np.linalg.inv(kf_odom[ki])
        out[ok] = anchor[ok] @ odom[ok]
        return out

    def trajectory_times(self):
        n = int(self.p.scan_i)
        return self.p.traj_t[:n].cpu().numpy()
