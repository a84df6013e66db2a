"""Loop detection & verification (port of ``sc_lego_loam_tpu/loop.py``;
reference mapOptmization.cpp:829-1110).

Two detectors, as in the reference:
- RS: radius search over key poses (20 m, >= 30 s time gap,
  mO.cpp:854-873), here a masked argmin over the pose bank;
- SC: Scan Context retrieval (models/scan_context.py).

Verification: ICP of the current keyframe cloud against a +-history_num
keyframe submap (mO.cpp:896-949), accepted if fitness < 1.5 (utility.h:139)
and two further gates pass.  The resulting between-factor measurement is
Z = (dT @ X_place)^-1 @ X_cand, where X_place is the pose the query cloud
was expressed at (the current estimate for RS; the candidate pose for SC,
mO.cpp:926-929) and dT the ICP correction.
"""

from __future__ import annotations

import torch

from . import mapping, posegraph
from .config import PipelineConfig
from .mapping import KeyframeStore
from .models import scan_context
from .ops import icp, voxel
from .parallel import mesh as mesh_mod, retrieval
from .utils import se3


def _row(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``bank[idx]`` for a () device index, without reading it on the host."""
    return bank[idx.reshape(1).long()][0]


def detect_radius(config: PipelineConfig, kf: KeyframeStore,
                  cur_idx: torch.Tensor) -> torch.Tensor:
    """Nearest keyframe within rs_search_radius and >= rs_time_gap older.
    Returns its index () int64, or -1.  (The reference's radius search
    returns candidates distance-sorted and takes the first one meeting the
    time gap, i.e. the NEAREST, mapOptmization.cpp:854-873.)"""
    lcfg = config.loop
    cur = _row(kf.poses6, cur_idx)
    cur_time = _row(kf.times, cur_idx)
    K = kf.poses6.shape[0]
    d = torch.linalg.vector_norm(kf.poses6[:, 3:6] - cur[3:6], dim=-1)
    ok = (torch.arange(K, device=d.device) < kf.count) \
        & (d < lcfg.rs_search_radius) \
        & (cur_time - kf.times >= lcfg.rs_time_gap)
    best = torch.argmin(torch.where(ok, d, torch.inf))
    return torch.where(_row(ok, best), best, -1)


def history_submap(config: PipelineConfig, kf: KeyframeStore,
                   center: torch.Tensor, mesh=None):
    """World-frame submap of +-history_num keyframes around ``center``,
    voxel-decimated (mO.cpp:896-903, leaf history_leaf); with a ``mesh``
    the clouds come from banks sharded over 'kf'.
    Returns (pts (history_pad,3), mask)."""
    cap, lcfg = config.cap, config.loop
    h = lcfg.history_num
    idx = center.long() + torch.arange(-h, h + 1, device=center.device)
    ok = (idx >= 0) & (idx < kf.count)
    idx = torch.clamp(idx, 0, cap.max_keyframes - 1)
    poses = se3.pose6_to_mat(kf.poses6[idx])

    def world(pts, mask):
        out = (poses[:, None, :3, :3] @ pts[..., None])[..., 0] \
            + poses[:, None, :3, 3]
        return out.reshape(-1, 3), (mask & ok[:, None]).reshape(-1)

    c, cm, s, sm, o, om = mapping.keyframe_clouds(kf, idx, mesh)
    c, cm = world(c, cm)
    s, sm = world(s, sm)
    o, om = world(o, om)
    return voxel.voxel_decimate(torch.cat([c, s, o]), torch.cat([cm, sm, om]),
                                lcfg.history_leaf, cap.history_pad)


def keyframe_cloud(config: PipelineConfig, kf: KeyframeStore,
                   idx: torch.Tensor, place_pose: torch.Tensor, mesh=None):
    """Corner+surf cloud of keyframe ``idx`` expressed at ``place_pose``
    (mO.cpp:880-894/926-929). Returns (pts (icp_query_pad,3), mask)."""
    n = config.cap.icp_query_pad
    c, cm, s, sm = (x[0] for x in mesh_mod.gather_rows(
        (kf.corner, kf.corner_mask, kf.surf, kf.surf_mask),
        idx.reshape(1).long(), mesh))
    pts = torch.cat([c, s])[:n]
    mask = torch.cat([cm, sm])[:n]
    out = se3.transform_points(place_pose, pts)
    return torch.where(mask[:, None], out, 0.0), mask


def verify(config: PipelineConfig, kf: KeyframeStore,
           cur_idx: torch.Tensor, cand_idx: torch.Tensor,
           place_pose: torch.Tensor, yaw_init: torch.Tensor | None = None,
           mesh=None):
    """ICP-verify a loop hypothesis. Returns (Z (4,4), fitness, accept).

    ``yaw_init``: relative yaw from Scan Context retrieval, which seeds the
    ICP so that reverse revisits close too (the reference leaves its
    ICP-with-initial-guess path disabled, mO.cpp:1062-1068)."""
    src, src_mask = keyframe_cloud(config, kf, cur_idx, place_pose, mesh)
    dst, dst_mask = history_submap(config, kf, cand_idx, mesh)
    if yaw_init is not None:
        # Scene yawed by +yaw => sensor yawed by -yaw; conjugate into the
        # world frame around the placement pose.
        zero = torch.zeros_like(yaw_init)
        Rz = se3.rt_to_mat(se3.euler_zyx_to_mat(-yaw_init, zero, zero),
                           torch.zeros(3, dtype=yaw_init.dtype,
                                       device=yaw_init.device))
        T0 = place_pose @ Rz @ se3.mat_inv(place_pose)
    else:
        T0 = None
    dT, fitness, inliers = icp.align(config, src, src_mask, dst, dst_mask,
                                     T0=T0)
    x_cand = se3.pose6_to_mat(_row(kf.poses6, cand_idx))
    Z = se3.mat_inv(dT @ place_pose) @ x_cand
    # Three gates (the reference has only the first, utility.h:139):
    # 1. mean-square fitness; 2. overlap (icp.align's inlier ratio);
    # 3. orientation plausibility: the factor's implied ROTATION against
    #    the current graph must be within accumulated-heading-drift range
    #    (loop.max_rot_residual; kills aliased matches between self-similar
    #    places that ICP aligns at a structurally wrong yaw).
    x_cur = se3.pose6_to_mat(_row(kf.poses6, cur_idx))
    r = se3.se3_log(se3.mat_inv(Z) @ se3.mat_inv(x_cur) @ x_cand)
    rot_ok = torch.linalg.vector_norm(r[:3]) <= config.loop.max_rot_residual
    accept = (fitness < config.loop.fitness_threshold) & \
             (inliers >= config.loop.min_inlier_ratio) & rot_ok
    return Z, fitness, accept


def verify_and_add(config: PipelineConfig, kf: KeyframeStore,
                   loops: posegraph.LoopFactors, cur: torch.Tensor,
                   idx: torch.Tensor, place: torch.Tensor,
                   yaw: torch.Tensor | None, mesh=None):
    """Verify one hypothesis and merge its factor into ``loops`` with
    ``torch.where``: a rejected one leaves the bank bit-identical.
    Returns (loops, accepted)."""
    Z, _, ok = verify(config, kf, cur, idx, place, yaw_init=yaw, mesh=mesh)
    new = posegraph.add_loop(loops, cur, idx, Z, kf.poses6)
    return posegraph.LoopFactors(
        *(torch.where(ok, b, a) for a, b in zip(loops, new))), ok


def sc_hypothesis(kf: KeyframeStore, sc_idx: torch.Tensor):
    """(candidate, placement) of a Scan Context hit: the query cloud is
    placed at the candidate's pose (mO.cpp:926-929)."""
    idx = torch.clamp(sc_idx, min=0)
    return idx, se3.pose6_to_mat(_row(kf.poses6, idx))


def rs_hypothesis(kf: KeyframeStore, cur: torch.Tensor,
                  rs_idx: torch.Tensor):
    """(candidate, placement) of a radius-search hit: the query cloud stays
    at the current estimate."""
    return torch.clamp(rs_idx, min=0), se3.pose6_to_mat(_row(kf.poses6, cur))


def device_tick(config: PipelineConfig, kf: KeyframeStore, bank,
                loops: posegraph.LoopFactors, cur_desc: torch.Tensor,
                mesh=None):
    """One full loop-closure tick (the reference's 1 Hz loopClosureThread,
    mO.cpp:829-839): detection, ICP verification, factor insertion and the
    pose-graph re-solve.

    Returns (kf, loops, closed () bool) with kf.poses6 rewritten from the
    pose-graph solution when a loop was accepted (correctPoses,
    mO.cpp:1642-1664).

    The JAX package gates the verifications and the re-solve with
    ``lax.cond`` on device scalars.  Here the two detectors' verdicts are
    read on the host together (one read), and ``closed`` once more before
    the re-solve: a tick without a candidate then costs the retrieval only,
    and an unclosed tick returns the very tensors it was given.  An
    accepted factor is merged with ``torch.where``, so a rejected one
    leaves the bank bit-identical.

    With a ``mesh`` the cloud and descriptor banks are this rank's blocks
    of banks sharded over 'kf': retrieval is ``retrieval.detect_sharded``,
    the clouds come by ``gather_rows`` and the re-solve shards the loop
    factors.  Every rank must take the same branch (the next collective
    would wait forever otherwise); the flags derive from replicated or
    all-reduced values, and ``mesh.agree`` checks that they do."""
    cur = torch.clamp(kf.count - 1, min=0)
    dev = cur.device

    # Scan Context path (mO.cpp:914-949,1053-1093) and radius-search path
    # (mO.cpp:854-873,1005-1048); neither reads what the other writes.
    if mesh is None:
        sc_idx, _, sc_yaw = scan_context.detect(config, bank, cur_desc)
    else:
        sc_idx, _, sc_yaw = retrieval.detect_sharded(
            config, mesh, bank.desc, bank.count, cur_desc)
    rs_idx = detect_radius(config, kf, cur)
    run_sc, run_rs = mesh_mod.agree(torch.stack(
        [sc_idx >= 0, (rs_idx >= 0) & (rs_idx != sc_idx)]), mesh)

    closed = torch.zeros((), dtype=torch.bool, device=dev)
    if run_sc:
        # The SC yaw seeds the verification ICP.
        loops, ok = verify_and_add(config, kf, loops, cur,
                                   *sc_hypothesis(kf, sc_idx), sc_yaw, mesh)
        closed = closed | ok
    if run_rs:
        loops, ok = verify_and_add(config, kf, loops, cur,
                                   *rs_hypothesis(kf, cur, rs_idx), None,
                                   mesh)
        closed = closed | ok

    if (run_sc or run_rs) and mesh_mod.agree(closed, mesh):
        kf = kf._replace(poses6=posegraph.solve(
            config, kf.poses6, kf.count, kf.odom_z, loops, mesh=mesh))
    return kf, loops, closed
