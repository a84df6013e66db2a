"""The SLAM engine (port of ``sc_lego_loam_tpu/pipeline.py``).

Three steps over device-resident state, as in the JAX package:

  perception_step   every scan      frontend -> de-skew -> features ->
                                    odometry -> fused pose -> trajectory
  mapping_step      >= 0.3 s apart  submap -> scan-to-map LM -> correction
                                    -> guarded keyframe + descriptor insert
  loop_step         every Nth tick  SC + radius detection -> ICP -> factor
                                    -> pose-graph re-solve -> correctPoses

The host schedules (the mapping cadence is a wall-clock gate in the
reference, utility.h:109; the loop cadence counts mapping ticks).  No step
reads a device value on the host on the card, so ``SlamEngine`` there
replays each as a CUDA graph (``graphs.py``, the JAX package's ``jit`` on
the three steps): ``loop_step``'s gates (a tick without a candidate skips
the ICP, one without an accepted factor the re-solve, a converged re-solve
its remaining iterations) and the odometry LM's iterations after it has
converged are CUDA-graph conditional nodes (``graphs.cond``, the JAX
package's ``lax.cond``); run eagerly they are host reads of the flags (see
``loop.device_tick``).  The trajectory and
the launch counts of conditional bodies are fetched once, by
``trajectory_array``.  State updates are in place where a buffer is large
(trajectory rings, keyframe and descriptor banks).

With ``imu.enabled`` the caller feeds IMU samples (``push_imu_batch``, all
samples up to a scan's end before that scan); they de-skew the cloud, give
the odometry its rotation prior and blend a sliver of roll / pitch into the
mapped pose.  None of that reads a device value on the host either.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .config import PipelineConfig

from . import (frontend, graphs, imu as imu_mod, loop, mapping, odometry,
               posegraph)
from .models import scan_context
from .ops import features as features_op
from .ops.compact import compact_indices
from .parallel import mesh as mesh_mod
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


# MapperState leaves whose rows a mesh shards over 'kf' (the JAX package's
# ``_shard_mapper_state``); everything else is whole on every rank.
SHARDED_LEAVES = tuple("kf." + f for f in mapping.SHARDED_FIELDS) + (
    "bank.desc", "bank.ringkey")


def init_mapper_state(config: PipelineConfig, device,
                      mesh=None) -> MapperState:
    """An empty mapper state; with a ``mesh``, the ``SHARDED_LEAVES``
    hold this rank's K/n rows."""
    ms = mapping.init_state(config, device, mesh)
    return MapperState(
        kf=ms.kf, bank=scan_context.init_bank(config, device, mesh),
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
    graphs.probe("perception.begin")
    fo = frontend.run(cfg, points, mask)
    fo = _pre_deskew(cfg, fo, state.odo, state.imu, t)
    graphs.probe("perception.frontend")
    fs, out_pts, out_mask = _extract(cfg, fo.cloud, fo.outlier)
    graphs.probe("perception.features")
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
    graphs.probe("perception.end")
    return state, odom_pose, out_pts, out_mask, fused


def mapping_step(config: PipelineConfig, mst: MapperState,
                 corner_xyz, corner_mask, surf_xyz, surf_mask,
                 out_pts, out_mask, odom_pose, points, mask, t, imu_buf=None,
                 mesh=None):
    """One mapping tick (reference run(), mO.cpp:1673-1708): submap ->
    scan-to-map LM -> correction -> guarded keyframe insert.  ``imu_buf``
    is read only with ``imu.enabled``.  With a ``mesh`` the banks are
    sharded over 'kf': the submap is gathered across the ranks, the
    downsampled scan is the first rank's (the voxel filter's float sums
    round run to run on the card), and the owner writes the rows."""
    cfg = config
    graphs.probe("mapping.begin")
    sub_c, sub_cm, sub_s, sub_sm = mapping.build_submap(cfg, mst.kf, mesh)
    c, cm, s, sm, o, om = mapping.downsample_scan(
        cfg, corner_xyz, corner_mask, surf_xyz, surf_mask, out_pts, out_mask)
    if mesh is not None:
        c, cm, s, sm, o, om = mesh_mod.share((c, cm, s, sm, o, om), mesh)
    graphs.probe("mapping.submap")

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
        odom_pose=odom_pose, mesh=mesh)
    desc = scan_context.make_descriptor(points, mask, cfg.sc)
    bank = scan_context.append(mst.bank, desc, cfg.cap.max_keyframes, should,
                               mesh)
    graphs.probe("mapping.end", inserted)
    return MapperState(
        kf=kf, bank=bank, loops=mst.loops, correction=correction, pose=pose,
        last_kf_pose=torch.where(inserted, pose, mst.last_kf_pose),
        last_kf_odom=torch.where(inserted, odom_pose, mst.last_kf_odom),
        loops_closed=mst.loops_closed,
        kf_dropped=mst.kf_dropped + (should & ~inserted).to(torch.int32))


def loop_step(config: PipelineConfig, mst: MapperState,
              mesh=None) -> MapperState:
    """One loop-closure tick (loopClosureThread analog, mO.cpp:829-839):
    SC + RS detection, ICP verification, factor insertion, pose-graph
    re-solve and correctPoses (mO.cpp:1642-1664): a closed tick rewrites
    pose, correction and last_kf_pose from the re-solved graph.  The big
    keyframe cloud banks are only read (across the ranks with a
    ``mesh``)."""
    graphs.probe("loop.begin")
    cur = torch.clamp(mst.kf.count.long() - 1, min=0).reshape(1)
    kf, loops, closed = loop.device_tick(
        config, mst.kf, mst.bank, mst.loops,
        mesh_mod.gather_rows(mst.bank.desc, cur, mesh)[0], mesh)
    new_pose = se3.pose6_to_mat(kf.poses6[cur][0])
    new_corr = new_pose @ se3.mat_inv(mst.last_kf_odom)
    graphs.probe("loop.end", closed)
    return mst._replace(
        kf=kf, loops=loops,
        correction=torch.where(closed, new_corr, mst.correction),
        pose=torch.where(closed, new_pose, mst.pose),
        last_kf_pose=torch.where(closed, new_pose, mst.last_kf_pose),
        loops_closed=mst.loops_closed + closed.to(torch.int32))


def graph_trajectory(fused, odom, t, kf, kf_n: int):
    """Every scan re-expressed through its keyframe anchor,
    X_k @ odom_k^-1 @ odom_i with k the last keyframe at or before scan i
    (numpy (N,4,4); scans before the first keyframe keep ``fused``)."""
    kf_t = kf.times[:kf_n].cpu().numpy()
    kf_pose = se3.pose6_to_mat(kf.poses6[:kf_n]).cpu().numpy()
    kf_odom = kf.odom_pose[:kf_n].cpu().numpy()
    k = np.searchsorted(kf_t, t + 1e-6) - 1          # last kf <= t_i
    out = fused.copy()
    ok = k >= 0
    ki = np.clip(k, 0, kf_n - 1)
    anchor = kf_pose[ki] @ np.linalg.inv(kf_odom[ki])
    out[ok] = anchor[ok] @ odom[ok]
    return out


def upload(rows: np.ndarray, device: torch.device, out=None) -> torch.Tensor:
    """A host array onto ``device`` (into ``out`` if given) without a host
    sync: through a pinned staging tensor of its own (the caching host
    allocator keeps it alive until the copy has run)."""
    src = torch.from_numpy(rows)
    if device.type != "cuda":
        return src if out is None else out.copy_(src)
    staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    staged.copy_(src)
    if out is None:
        return staged.to(device, non_blocking=True)
    return out.copy_(staged, non_blocking=True)


def stage(bufs, srcs, device: torch.device):
    """Copy each source (a tensor or a numpy array) into its static buffer
    on ``device``, host arrays through ``upload``."""
    for buf, src in zip(bufs, srcs):
        if tuple(src.shape) != tuple(buf.shape):
            raise ValueError(
                f"input of shape {tuple(src.shape)}: the graphs were built "
                f"for {tuple(buf.shape)}")
        if isinstance(src, torch.Tensor) and src.device.type == device.type:
            buf.copy_(src)
        else:
            if isinstance(src, torch.Tensor):
                src = src.numpy()
            dtype = np.bool_ if buf.dtype == torch.bool else np.float32
            upload(np.ascontiguousarray(src, dtype), device, out=buf)


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
    default raises.  ``process_scan`` reads a device value only inside an
    eager loop tick (none on the card's graphed engine);
    ``trajectory_array()`` fetches the run once.

    On the card ``perception_step``, ``mapping_step`` and ``loop_step``
    run as CUDA graph replays (``graphs.StepGraph``): the first call of
    each per-scan step runs eagerly (warm-up), the second captures; the
    first loop tick warms up on copies of the small state leaves (every
    gate's body run and kept only where its flag holds, so both sides of a
    gate are warm; the banks are only read) and captures at once; every
    later call is one graph launch over static buffers; the scan is
    uploaded into a static buffer.  The three graphs share one pool and
    the static state buffers: what one step writes the next one reads in
    place.  A loop tick's gates are conditional nodes, so a tick reads
    nothing on the host; without conditional nodes the graphed engine
    raises (``graphs.require_conditional_nodes``).  ``eager=True``
    (keyword only) keeps the op-by-op path, the gates read on the host:
    for comparisons against the graphs and per-sub-stage profiles.
    With a ``mesh`` (gloo and NCCL collectives are not captured here) and on
    the CPU the engine always runs eagerly; ``eager=False`` there raises.
    ``trace`` is the engine's tracer (``utils/profiling.StageTimer``), off
    until ``trace.on()``: host spans around each call and its steps, and
    the records of the probes inside the steps (``graphs.probe``), drained
    by ``trace.drain()``.
    The engine is bit for bit the same either way: the graphs replay the
    eager kernels, and every kernel on the path is deterministic (the voxel
    filter's and the pose graph's scatter-sums sort their indices).

    ``mesh`` (keyword only; a ``DeviceMesh`` with a 'kf' axis from
    ``parallel.mesh.make_mesh``): every rank of the 'kf' group runs the
    engine on the same scans and holds K/n rows of the keyframe cloud banks
    and of the descriptor bank (``SHARDED_LEAVES``), the memory that grows
    with the trajectory; poses, counts and the every-scan state stay whole
    on every rank.  The submap and loop-closure gathers, retrieval and the
    re-solve then run across the ranks (``parallel.mesh``)."""

    # Fixed pad so that every per-scan IMU batch has one shape.
    IMU_BATCH_PAD = 32

    def __init__(self, config: PipelineConfig, device="cuda", *, mesh=None,
                 eager: bool | None = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SlamEngine(device='cuda'): no CUDA device; pass "
                "device='cpu' to run the plain versions")
        graphable = self.device.type == "cuda" and mesh is None
        if eager is None:
            eager = not graphable
        elif not eager and not graphable:
            raise ValueError(
                "SlamEngine(eager=False): CUDA graphs need a CUDA device "
                "and no mesh (collectives are not captured)")
        # fp32 everywhere, as the JAX entry points' "highest" precision.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # cuBLAS is deterministic on one stream with a fixed workspace;
        # torch's deterministic mode asks for this setting.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        self.config = config
        self.mesh = mesh
        self.shard = mesh_mod.bank_sharding(mesh)
        if self.shard is not None:
            assert config.cap.max_keyframes % self.shard.size == 0, (
                f"max_keyframes {config.cap.max_keyframes} does not split "
                f"over {self.shard.size} 'kf' ranks")
        self.p = init_perception_state(config, self.device)
        self.m = init_mapper_state(config, self.device, self.shard)
        self.last_map_time = -1e9
        self.map_ticks = 0
        self.loop_ticks = 0
        # The tracer (utils/profiling.py), off until trace.on(): host
        # spans around the calls, probes inside the steps.
        self.trace = StageTimer(on=False,
                                probes=graphs.ProbeRing(self.device))
        self._scans_fed = 0
        self._warned_kf_cap = False
        self._warned_loop_cap = False
        trace = self.trace

        def probed(fn):
            # The tracer's ring as the step runs (a graph keeps the one
            # its capture saw).
            def step(*args):
                with graphs.probing(trace.probes):
                    return fn(*args)
            return step

        cfg, shard = config, self.shard
        self._steps = (
            probed(lambda p, corr, pts, msk, t: perception_step(
                cfg, p, corr, pts, msk, t)),
            probed(lambda m, *args: (mapping_step(cfg, m, *args,
                                                  mesh=shard),)),
            probed(lambda m: (loop_step(cfg, m, mesh=shard),)))
        self.graphs = None
        self._scan_buf = None
        if not eager:
            self.use_graphs(graphs.CudaCapture(self.device))

    def use_graphs(self, backend):
        """Run the three steps through ``graphs.StepGraph``s on ``backend``
        (``graphs.CudaCapture``; the CPU tests hand in
        ``graphs.EagerStandIn``)."""
        perceive, map_step, loop_fn = self._steps
        self.graphs = (
            graphs.StepGraph(perceive, backend, "perception_step"),
            graphs.StepGraph(map_step, backend, "mapping_step"),
            graphs.StepGraph(loop_fn, backend, "loop_step",
                             warm_copy=graphs.small_copy))

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

    def push_imu(self, t: float, rpy, acc, gyro):
        """Feed one IMU sample (imuHandler, fA.cpp:431-489): world-frame
        roll/pitch/yaw, body linear acceleration (m/s^2, gravity included),
        body angular rate (rad/s).  Push all samples with timestamps up to
        a scan's end before feeding that scan."""
        row = upload(np.concatenate(
            [[t], rpy, acc, gyro]).astype(np.float32), self.device)
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
        rows = upload(rows, self.device)
        self.p = self.p._replace(imu=imu_mod.push_many(
            self.p.imu, rows[:, 0], rows[:, 1:4], rows[:, 4:7], rows[:, 7:10],
            rows[:, 10] > 0.5))

    def _stage_scan(self, points, mask, t: float):
        """The scan and its time on the device: fresh tensors eagerly; with
        graphs the static buffers, the scan through a pinned staging copy
        (or a device copy) and ``t`` by a fill."""
        if self.graphs is None:
            points = torch.as_tensor(points, dtype=torch.float32,
                                     device=self.device)
            mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
            # A fill kernel, not a host->device copy (which would sync).
            return points, mask, torch.full((), t, dtype=torch.float32,
                                            device=self.device)
        if self._scan_buf is None:
            n = len(points)
            self._scan_buf = (
                torch.empty((n, 3), dtype=torch.float32, device=self.device),
                torch.empty(n, dtype=torch.bool, device=self.device),
                torch.empty((), dtype=torch.float32, device=self.device))
        buf_pts, buf_msk, buf_t = self._scan_buf
        stage((buf_pts, buf_msk), (points, mask), self.device)
        buf_t.fill_(t)
        return buf_pts, buf_msk, buf_t

    def process_scan(self, points, mask, t: float):
        """Feed one scan (padded (N,3) + mask, numpy or tensors).  Returns
        the fused pose as a device tensor (no sync)."""
        tr = self.trace
        tr.scan = self._scans_fed
        with tr.stage("process_scan"):
            return self._process_scan(points, mask, t)

    def _process_scan(self, points, mask, t: float):
        cfg, tr = self.config, self.trace
        with tr.stage("stage_scan"):
            points, mask, t_dev = self._stage_scan(points, mask, t)

        self._scans_fed += 1
        if self._scans_fed == cfg.cap.max_scans + 1:
            warnings.warn(
                f"trajectory ring buffer full ({cfg.cap.max_scans} scans): "
                "later poses overwrite the last slot; raise "
                "CapacityConfig.max_scans", RuntimeWarning)

        with tr.stage("perception_step"):
            self.p, odom_pose, out_pts, out_mask, fused = self._step(0)(
                self.p, self.m.correction, points, mask, t_dev)
        if self.graphs is not None:
            fused = fused.clone()   # the graph's output is rewritten

        if t - self.last_map_time >= cfg.mapping.process_interval:
            self.last_map_time = t
            odo = self.p.odo
            args = (odo.corner_last.xyz, odo.corner_last.mask,
                    odo.surf_last.xyz, odo.surf_last.mask, out_pts, out_mask,
                    odom_pose, points, mask, t_dev, self.p.imu)
            with tr.stage("mapping_step"):
                (self.m,) = self._step(1)(self.m, *args)
            self.map_ticks += 1
            # Loop-closure cadence: every Nth mapping tick (the reference's
            # 1 Hz thread vs its ~3.3 Hz mapping = every ~3rd tick).
            if cfg.loop.enabled and \
                    self.map_ticks % cfg.loop.check_every_ticks == 0:
                self.loop_tick()
                self.loop_ticks += 1
        if not (self._warned_kf_cap and self._warned_loop_cap):
            self._check_caps_host_bound()
        return fused

    def loop_tick(self):
        """One loop-closure tick on the mapper state: ``loop_step``
        eagerly, or a replay of its graph."""
        with self.trace.stage("loop_step"):
            (self.m,) = self._step(2)(self.m)

    def _step(self, k: int):
        """Step ``k`` (0 perception, 1 mapping, 2 loop): its graph, or the
        step itself when the engine runs eagerly."""
        return self._steps[k] if self.graphs is None else self.graphs[k]

    def _check_caps_host_bound(self):
        """Warn from the host-side tick counters alone, which bound the
        device counters (keyframe inserts <= mapping ticks; loop factors
        <= 2 per loop tick): no device read.  The loop bound counts the
        loop ticks that ran: the JAX package counts map_ticks //
        check_every_ticks, loop closure on or off, and so warns of a loop
        bank that cannot fill when it is off."""
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
        """Fetch the cap counters and warn exactly, as the JAX package
        does: both flags are reset, each warning fires at most once a call
        and sets its flag (so the host-bound warnings stop once an exact
        one has fired).  Keyframes past the cap were dropped, loop factors
        past it overwrote the highest-residual factor
        (posegraph.add_loop)."""
        cfg = self.config
        self._warned_kf_cap = False
        self._warned_loop_cap = False
        kf_dropped, loops_count = int(self.m.kf_dropped), \
            int(self.m.loops.count)
        if not self._warned_kf_cap and kf_dropped > 0:
            warnings.warn(
                f"keyframe bank full ({cfg.cap.max_keyframes}): "
                f"{kf_dropped} keyframes dropped so far; raise "
                "CapacityConfig.max_keyframes", RuntimeWarning)
            self._warned_kf_cap = True
        if not self._warned_loop_cap and \
                loops_count > cfg.posegraph.max_loops:
            warnings.warn(
                f"loop-factor bank full ({cfg.posegraph.max_loops}): "
                "lowest-information loop factors are being overwritten; "
                "raise PoseGraphConfig.max_loops", RuntimeWarning)
            self._warned_loop_cap = True

    def trajectory_array(self, retro_correct: bool = True):
        """(N,4,4) numpy trajectory so far (one fetch).  ``retro_correct``
        re-expresses every scan through its keyframe anchor
        X_k @ odom_k^-1 @ odom_i (the reference's exported key-pose path);
        ``False`` returns the as-published fused stream."""
        n = int(self.p.scan_i)
        self._check_caps()
        graphs.flush_counts()
        fused = self.p.traj[:n].cpu().numpy()
        if not retro_correct or n == 0:
            return fused
        kf_n = int(self.m.kf.count)
        if kf_n == 0:
            return fused
        return graph_trajectory(
            fused, self.p.odom_traj[:n].cpu().numpy(),
            self.p.traj_t[:n].cpu().numpy(), self.m.kf, kf_n)

    def trajectory_times(self):
        n = int(self.p.scan_i)
        return self.p.traj_t[:n].cpu().numpy()
