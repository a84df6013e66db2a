"""The SLAM engine (port of ``sc_lego_loam_tpu/pipeline.py``).

Three steps over device-resident state, as in the JAX package:

  perception_step   every scan      frontend -> de-skew -> features ->
                                    odometry -> fused pose -> trajectory
  mapping_step      >= 0.3 s apart  submap -> scan-to-map LM -> correction
                                    -> guarded keyframe + descriptor insert
  loop_step         every Nth tick  SC + radius detection -> ICP -> factor
                                    -> pose-graph re-solve -> correctPoses

The host schedules (the mapping cadence is a wall-clock gate in the
reference, utility.h:109; the loop cadence counts mapping ticks).
``perception_step`` and ``mapping_step`` read no device value on the host;
``loop_step`` reads a few flags (see ``loop.device_tick``) so that a tick
without a candidate skips the ICP and one without an accepted factor skips
the re-solve.  The trajectory is fetched once, by ``trajectory_array``.
State updates are in place where a buffer is large (trajectory rings,
keyframe and descriptor banks).

With ``imu.enabled`` the caller feeds IMU samples (``push_imu_batch``, all
samples up to a scan's end before that scan); they de-skew the cloud, give
the odometry its rotation prior and blend a sliver of roll / pitch into the
mapped pose.  None of that reads a device value on the host either.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from .config import PipelineConfig

from . import frontend, imu as imu_mod, loop, mapping, odometry, posegraph
from .models import scan_context
from .ops import features as features_op
from .ops.compact import compact_indices
from .utils import se3
from .utils.profiling import StageTimer


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


def _pre_deskew(config: PipelineConfig, fo, odo_state, imu_buf=None,
                t=None):
    """De-skew the segmented cloud AND the outlier grid into the scan-END
    frame, once per scan (the adjustDistortion slot, fA.cpp:491-619);
    rel_time becomes 1.

    Lidar-only: constant-twist prediction from the carried previous twist
    (``odometry.deskew_with_twist``).  With the IMU enabled and more than
    one sample buffered: ``imu.deskew_to_end``, chosen on the device."""
    cfg = config
    use_ct = cfg.odom.deskew
    use_imu = cfg.imu.enabled and cfg.imu.deskew
    if not (use_ct or use_imu):
        return fo
    xi0 = odo_state.motion
    if use_imu:
        imu_ok = imu_buf.count > 1
        v_world = (odo_state.pose[:3, :3] @ odo_state.motion[3:]) \
            / cfg.lidar.scan_period

    def ds(grid_xyz, grid_rel, grid_valid):
        flat = grid_xyz.reshape(-1, 3)
        rel = grid_rel.reshape(-1)
        pts = odometry.deskew_with_twist(xi0, flat, rel) if use_ct else flat
        if use_imu:
            pts_imu = imu_mod.deskew_to_end(
                imu_buf, flat, rel, t, cfg.lidar.scan_period, v_world)
            pts = torch.where(imu_ok, pts_imu, pts)
        xyz = pts.reshape(grid_xyz.shape)
        return (torch.where(grid_valid[..., None], xyz, 0.0),
                grid_valid.to(grid_rel.dtype))

    cloud, outl = fo.cloud, fo.outlier
    c_xyz, c_rel = ds(cloud.xyz, cloud.rel_time, cloud.valid)
    o_xyz, o_rel = ds(outl.xyz, outl.rel_time, outl.valid)
    return fo._replace(
        cloud=cloud._replace(xyz=c_xyz, rel_time=c_rel),
        outlier=outl._replace(xyz=o_xyz, rel_time=o_rel))


def _odo_perception(config: PipelineConfig, points, mask, odo_state):
    """Frontend -> carried-twist de-skew -> features -> odometry, with no
    IMU and no trajectory rings: the vmappable core that
    ``parallel.batch`` runs over a batch of sequences.
    Returns (new_odo_state, odom_pose, out_pts, out_mask)."""
    fo = frontend.run(config, points, mask)
    fo = _pre_deskew(config, fo, odo_state)
    fs, out_pts, out_mask = _extract(config, fo.cloud, fo.outlier)
    odo, odom_pose, _ = odometry.step(config, odo_state, fs)
    return odo, odom_pose, out_pts, out_mask


class PerceptionState(NamedTuple):
    """Device state of the every-scan path."""

    odo: odometry.OdometryState
    imu: imu_mod.ImuBuffer
    traj: torch.Tensor         # (max_scans, 4, 4) fused poses
    odom_traj: torch.Tensor    # (max_scans, 4, 4) raw odometry poses
    traj_t: torch.Tensor       # (max_scans,)
    scan_i: torch.Tensor       # () int32


class MapperState(NamedTuple):
    """Device state of the mapping path."""

    kf: mapping.KeyframeStore
    bank: scan_context.DescriptorBank
    loops: posegraph.LoopFactors
    correction: torch.Tensor   # (4,4) map-from-odom drift correction
    pose: torch.Tensor         # (4,4) latest mapped pose
    last_kf_pose: torch.Tensor  # (4,4) pose at last keyframe insertion
    last_kf_odom: torch.Tensor  # (4,4) odometry pose at last keyframe
    loops_closed: torch.Tensor  # () int32 — loop ticks that closed
    kf_dropped: torch.Tensor   # () int32 — keyframes dropped at full bank


def init_perception_state(config: PipelineConfig, device) -> PerceptionState:
    n = config.cap.max_scans
    return PerceptionState(
        odo=odometry.init_state(config, device),
        imu=imu_mod.init_buffer(config.imu.que_len, device),
        traj=torch.eye(4, device=device).repeat(n, 1, 1),
        odom_traj=torch.eye(4, device=device).repeat(n, 1, 1),
        traj_t=torch.zeros(n, device=device),
        scan_i=torch.zeros((), dtype=torch.int32, device=device))


def init_mapper_state(config: PipelineConfig, device) -> MapperState:
    ms = mapping.init_state(config, device)
    return MapperState(
        kf=ms.kf, bank=scan_context.init_bank(config, device),
        loops=posegraph.init_loops(config, device),
        correction=ms.correction, pose=ms.pose,
        last_kf_pose=ms.last_kf_pose,
        last_kf_odom=torch.eye(4, device=device),
        loops_closed=torch.zeros((), dtype=torch.int32, device=device),
        kf_dropped=torch.zeros((), dtype=torch.int32, device=device))


def perception_step(config: PipelineConfig, state: PerceptionState,
                    correction, points, mask, t):
    """Per-scan step: frontend -> de-skew -> features -> odometry -> fusion.
    Writes the trajectory rings in place.
    Returns (state, odom_pose, out_pts, out_mask, fused_pose)."""
    cfg = config
    fo = frontend.run(cfg, points, mask)
    fo = _pre_deskew(cfg, fo, state.odo, state.imu, t)
    fs, out_pts, out_mask = _extract(cfg, fo.cloud, fo.outlier)
    if cfg.imu.enabled and cfg.imu.prior:
        # IMU initial guess (updateInitialGuess, fA.cpp:1639-1664): the
        # orientation delta is trusted (attitude is drift-bounded); the
        # dead-reckoned translation depends on an unobservable initial
        # velocity, so translation keeps the constant-velocity prior.
        xi_imu = imu_mod.motion_prior(state.imu, t, t + cfg.lidar.scan_period)
        ok = (state.imu.count > 1) & torch.isfinite(xi_imu).all()
        xi_prior = torch.where(
            ok, torch.cat([xi_imu[:3], state.odo.motion[3:]]),
            state.odo.motion)
    else:
        xi_prior = None
    odo, odom_pose, _ = odometry.step(cfg, state.odo, fs, xi_prior)

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
                 out_pts, out_mask, odom_pose, points, mask, t, imu_buf=None):
    """One mapping tick (reference run(), mO.cpp:1673-1708): submap ->
    scan-to-map LM -> correction -> guarded keyframe insert.  ``imu_buf``
    is read only with ``imu.enabled``."""
    cfg = config
    sub_c, sub_cm, sub_s, sub_sm = mapping.build_submap(cfg, mst.kf)
    c, cm, s, sm, o, om = mapping.downsample_scan(
        cfg, corner_xyz, corner_mask, surf_xyz, surf_mask, out_pts, out_mask)

    T_guess = mst.correction @ odom_pose
    pose = mapping.scan_to_map(cfg, T_guess, c, cm, torch.cat([s, o]),
                               torch.cat([sm, om]), sub_c, sub_cm, sub_s,
                               sub_sm)
    if cfg.imu.enabled:
        # transformUpdate (mO.cpp:484-517): blend a sliver of the IMU
        # roll/pitch into the mapped pose to bound long-horizon tilt drift.
        rpy_i = imu_mod.rpy_at(imu_buf, t)
        p6 = se3.mat_to_pose6(pose)
        b = cfg.imu.blend
        p6b = torch.cat([(1 - b) * p6[:2] + b * rpy_i[:2], p6[2:]])
        pose = torch.where(imu_buf.count > 1, se3.pose6_to_mat(p6b), pose)
    correction = pose @ se3.mat_inv(odom_pose)

    should = mapping.should_insert_keyframe(cfg, mst.last_kf_pose, pose)
    kf, inserted = mapping.insert_keyframe(
        cfg, mst.kf, should, pose, t, c, cm, s, sm, o, om,
        odom_pose=odom_pose)
    desc = scan_context.make_descriptor(points, mask, cfg.sc)
    bank = scan_context.append(mst.bank, desc, cfg.cap.max_keyframes, should)
    return MapperState(
        kf=kf, bank=bank, loops=mst.loops, correction=correction, pose=pose,
        last_kf_pose=torch.where(inserted, pose, mst.last_kf_pose),
        last_kf_odom=torch.where(inserted, odom_pose, mst.last_kf_odom),
        loops_closed=mst.loops_closed,
        kf_dropped=mst.kf_dropped + (should & ~inserted).to(torch.int32))


def loop_step(config: PipelineConfig, mst: MapperState) -> MapperState:
    """One loop-closure tick (loopClosureThread analog, mO.cpp:829-839):
    SC + RS detection, ICP verification, factor insertion, pose-graph
    re-solve and correctPoses (mO.cpp:1642-1664): a closed tick rewrites
    pose, correction and last_kf_pose from the re-solved graph.  The big
    keyframe cloud banks are only read."""
    cur = torch.clamp(mst.kf.count.long() - 1, min=0).reshape(1)
    kf, loops, closed = loop.device_tick(
        config, mst.kf, mst.bank, mst.loops, mst.bank.desc[cur][0])
    new_pose = se3.pose6_to_mat(kf.poses6[cur][0])
    new_corr = new_pose @ se3.mat_inv(mst.last_kf_odom)
    return mst._replace(
        kf=kf, loops=loops,
        correction=torch.where(closed, new_corr, mst.correction),
        pose=torch.where(closed, new_pose, mst.pose),
        last_kf_pose=torch.where(closed, new_pose, mst.last_kf_pose),
        loops_closed=mst.loops_closed + closed.to(torch.int32))


def _own(state, device):
    """A copy of a state tuple (or tensor) with every leaf its own tensor
    on ``device``: the engine writes its banks in place."""
    if isinstance(state, torch.Tensor):
        return state.detach().to(device, copy=True)
    return type(state)(*(_own(leaf, device) for leaf in state))


class SlamEngine:
    """Single-sequence SLAM (BASELINE.json configs 1-3), with or without
    loop closure and IMU.  ``device`` is ``"cuda"`` unless the caller asks
    for ``"cpu"`` (the plain versions of the kernels); without a card the
    default raises.  ``process_scan`` reads a device value only inside a
    loop tick (and in the LM loops' ``eigh``); ``trajectory_array()``
    fetches the run once."""

    # Fixed pad so that every per-scan IMU batch has one shape.
    IMU_BATCH_PAD = 32

    def __init__(self, config: PipelineConfig, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SlamEngine(device='cuda'): no CUDA device; pass "
                "device='cpu' to run the plain versions")
        # fp32 everywhere, as the JAX entry points' "highest" precision.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.p = init_perception_state(config, self.device)
        self.m = init_mapper_state(config, self.device)
        self.last_map_time = -1e9
        self.map_ticks = 0
        self.loop_ticks = 0
        self.timer = StageTimer()
        self._scans_fed = 0
        self._warned_kf_cap = False
        self._warned_loop_cap = False

    # Views of the device state for export, checkpoint and tests; the
    # setters copy what they are given onto the engine's device.

    @property
    def odo(self) -> odometry.OdometryState:
        return self.p.odo

    @odo.setter
    def odo(self, v):
        self.p = self.p._replace(odo=_own(v, self.device))

    @property
    def map(self) -> mapping.MapState:
        return mapping.MapState(
            kf=self.m.kf, correction=self.m.correction, pose=self.m.pose,
            last_kf_pose=self.m.last_kf_pose)

    @map.setter
    def map(self, v: mapping.MapState):
        v = _own(v, self.device)
        self.m = self.m._replace(kf=v.kf, correction=v.correction,
                                 pose=v.pose, last_kf_pose=v.last_kf_pose)

    @property
    def bank(self) -> scan_context.DescriptorBank:
        return self.m.bank

    @bank.setter
    def bank(self, v):
        self.m = self.m._replace(bank=_own(v, self.device))

    @property
    def loops(self) -> posegraph.LoopFactors:
        return self.m.loops

    @loops.setter
    def loops(self, v):
        self.m = self.m._replace(loops=_own(v, self.device))

    @property
    def loops_closed(self) -> torch.Tensor:
        return self.m.loops_closed

    def _upload(self, rows: np.ndarray) -> torch.Tensor:
        """A small host array onto the engine's device without a host sync:
        through a pinned staging tensor of its own (the caching host
        allocator keeps it alive until the copy has run)."""
        src = torch.from_numpy(rows)
        if self.device.type != "cuda":
            return src
        staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        staged.copy_(src)
        return staged.to(self.device, non_blocking=True)

    def push_imu(self, t: float, rpy, acc, gyro):
        """Feed one IMU sample (imuHandler, fA.cpp:431-489): world-frame
        roll/pitch/yaw, body linear acceleration (m/s^2, gravity included),
        body angular rate (rad/s).  Push all samples with timestamps up to
        a scan's end before feeding that scan."""
        row = self._upload(np.concatenate(
            [[t], rpy, acc, gyro]).astype(np.float32))
        self.p = self.p._replace(imu=imu_mod.push(
            self.p.imu, row[0], row[1:4], row[4:7], row[7:10]))

    def push_imu_batch(self, times, rpy, acc, gyro):
        """Feed up to IMU_BATCH_PAD samples in one padded batch (one upload
        and one ``imu.push_many``, whose launch count does not depend on
        the number of samples)."""
        m = len(times)
        P = self.IMU_BATCH_PAD
        assert m <= P, f"feed at most {P} samples per call, got {m}"
        rows = np.zeros((P, 11), np.float32)
        rows[:m, 0] = times
        rows[:m, 1:4] = rpy
        rows[:m, 4:7] = acc
        rows[:m, 7:10] = gyro
        rows[:m, 10] = 1.0
        rows = self._upload(rows)
        self.p = self.p._replace(imu=imu_mod.push_many(
            self.p.imu, rows[:, 0], rows[:, 1:4], rows[:, 4:7], rows[:, 7:10],
            rows[:, 10] > 0.5))

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

        with self.timer.stage("perception"):
            self.p, odom_pose, out_pts, out_mask, fused = perception_step(
                cfg, self.p, self.m.correction, points, mask, t_dev)

        if t - self.last_map_time >= cfg.mapping.process_interval:
            self.last_map_time = t
            odo = self.p.odo
            with self.timer.stage("mapping"):
                self.m = mapping_step(
                    cfg, self.m, odo.corner_last.xyz, odo.corner_last.mask,
                    odo.surf_last.xyz, odo.surf_last.mask, out_pts, out_mask,
                    odom_pose, points, mask, t_dev, self.p.imu)
            self.map_ticks += 1
            # Loop-closure cadence: every Nth mapping tick (the reference's
            # 1 Hz thread vs its ~3.3 Hz mapping = every ~3rd tick).
            if cfg.loop.enabled and \
                    self.map_ticks % cfg.loop.check_every_ticks == 0:
                with self.timer.stage("loop"):
                    self.m = loop_step(cfg, self.m)
                self.loop_ticks += 1
        if not (self._warned_kf_cap and self._warned_loop_cap):
            self._check_caps_host_bound()
        return fused

    def _check_caps_host_bound(self):
        """Warn from the host-side tick counters alone, which bound the
        device counters (keyframe inserts <= mapping ticks; loop factors
        <= 2 per loop tick): no device read."""
        cfg = self.config
        if not self._warned_kf_cap and \
                self.map_ticks >= cfg.cap.max_keyframes:
            warnings.warn(
                f"keyframe bank may be full ({cfg.cap.max_keyframes}): "
                "new keyframes past the cap are dropped; raise "
                "CapacityConfig.max_keyframes", RuntimeWarning)
            self._warned_kf_cap = True
        if not self._warned_loop_cap and \
                2 * self.loop_ticks > cfg.posegraph.max_loops:
            warnings.warn(
                f"loop-factor bank may be full ({cfg.posegraph.max_loops}): "
                "lowest-information factors are overwritten past the cap; "
                "raise PoseGraphConfig.max_loops", RuntimeWarning)
            self._warned_loop_cap = True

    def _check_caps(self):
        """Fetch the cap counters and warn exactly: keyframes
        past the cap were dropped, loop factors past it overwrote the
        highest-residual factor (posegraph.add_loop)."""
        cfg = self.config
        kf_dropped, loops_count = int(self.m.kf_dropped), \
            int(self.m.loops.count)
        if kf_dropped > 0:
            warnings.warn(
                f"keyframe bank full ({cfg.cap.max_keyframes}): "
                f"{kf_dropped} keyframes dropped so far; raise "
                "CapacityConfig.max_keyframes", RuntimeWarning)
        if loops_count > cfg.posegraph.max_loops:
            warnings.warn(
                f"loop-factor bank full ({cfg.posegraph.max_loops}): "
                "lowest-information loop factors are being overwritten; "
                "raise PoseGraphConfig.max_loops", RuntimeWarning)

    def trajectory_array(self, retro_correct: bool = True):
        """(N,4,4) numpy trajectory so far (one fetch).  ``retro_correct``
        re-expresses every scan through its keyframe anchor
        X_k @ odom_k^-1 @ odom_i (the reference's exported key-pose path);
        ``False`` returns the as-published fused stream."""
        n = int(self.p.scan_i)
        self._check_caps()
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
