"""Scan-to-map refinement & keyframe store (port of
``sc_lego_loam_tpu/mapping.py``; reference mapOptmization.cpp).

- Keyframe clouds live in preallocated (max_keyframes x pad) tensors with
  a count; a keyframe write is an in-place ``index_copy_`` at the device
  slot ``count`` (the bank is ~3 GB at full size, so it is never copied).
- The submap is the ``submap_recent_num`` most recent keyframes with loop
  closure ON, and the nearest ones within ``submap_search_radius`` of the
  latest pose with it OFF, transformed to the world frame and
  voxel-decimated.
- Scan-to-map is a 6-DOF Gauss-Newton on an se(3) twist: per research a
  5-NN in the submap (the CUDA kernel on the card), line fits by closed-
  form 3x3 eigen, plane fits by 3x3 normal equations, robust weights,
  degeneracy projection (the 6x6 eigendecomposition by ``ops/symeig``, a
  kernel that reads nothing back); a fixed iteration count with
  ``torch.where`` freezing after convergence, so a tick reads no device
  value on the host and can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from .config import PipelineConfig

from .ops import cuda_knn, solver, voxel
from .ops.compact import compact
from .parallel import mesh as mesh_mod
from .utils import se3


def _make_knn5(submap, submap_mask, m):
    """5-NN closure ``knn5(q, qcnt)`` with the target prep hoisted: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    return cuda_knn.make_knn(submap, submap_mask, m.knn,
                             4.0 * m.max_nn_sq_dist)


class KeyframeStore(NamedTuple):
    """Fixed-capacity keyframe bank."""

    poses6: torch.Tensor       # (K,6) (roll,pitch,yaw,x,y,z) world poses
    times: torch.Tensor        # (K,) scan timestamps (s)
    corner: torch.Tensor       # (K,Ckf,3) sensor-frame corner clouds
    corner_mask: torch.Tensor  # (K,Ckf)
    surf: torch.Tensor         # (K,Skf,3)
    surf_mask: torch.Tensor
    outlier: torch.Tensor      # (K,Okf,3)
    outlier_mask: torch.Tensor
    odom_z: torch.Tensor       # (K,4,4) odometry factors X_{k-1}^-1 X_k
    odom_pose: torch.Tensor    # (K,4,4) raw odometry pose at insertion
    count: torch.Tensor        # () int32 high-water


# The fields whose rows a mesh shards over 'kf' (the JAX package's
# ``pipeline._shard_mapper_state``): the keyframe clouds, the memory that
# grows with the trajectory.  Poses, times, odometry factors and the count
# stay whole on every rank.
SHARDED_FIELDS = ("corner", "corner_mask", "surf", "surf_mask", "outlier",
                  "outlier_mask")


class MapState(NamedTuple):
    kf: KeyframeStore
    correction: torch.Tensor   # (4,4) map-from-odom drift correction
    pose: torch.Tensor         # (4,4) latest mapped pose
    last_kf_pose: torch.Tensor  # (4,4) pose at last keyframe insertion


def init_state(config: PipelineConfig, device, mesh=None) -> MapState:
    """An empty map; with a ``mesh``, the cloud fields hold this rank's
    K/n rows of banks sharded over 'kf'."""
    cap = config.cap
    K = cap.max_keyframes
    Kc = K if mesh is None else mesh_mod.bank_sharding(mesh).block(K)[1]

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def eyes():
        return torch.eye(4, device=device).repeat(K, 1, 1)

    kf = KeyframeStore(
        poses6=zeros(K, 6), times=zeros(K),
        corner=zeros(Kc, cap.kf_corner_pad, 3),
        corner_mask=zeros(Kc, cap.kf_corner_pad, dtype=torch.bool),
        surf=zeros(Kc, cap.kf_surf_pad, 3),
        surf_mask=zeros(Kc, cap.kf_surf_pad, dtype=torch.bool),
        outlier=zeros(Kc, cap.kf_outlier_pad, 3),
        outlier_mask=zeros(Kc, cap.kf_outlier_pad, dtype=torch.bool),
        odom_z=eyes(), odom_pose=eyes(),
        count=zeros(dtype=torch.int32))
    eye = torch.eye(4, device=device)
    # last_kf_pose starts far away so the first scan becomes a keyframe.
    far = eye.clone()
    far[:3, 3] = 1e6
    return MapState(kf=kf, correction=eye.clone(), pose=eye.clone(),
                    last_kf_pose=far)


def _transform(T, pts):
    return (T[:3, :3] @ pts[..., None])[..., 0] + T[:3, 3]


def _top_k(score: torch.Tensor, k: int):
    """``lax.top_k``: descending, ties to the lower index."""
    val, sel = torch.sort(score, descending=True, stable=True)
    return val[:k], sel[:k]


def keyframe_clouds(kf: KeyframeStore, idx: torch.Tensor, mesh=None):
    """The six cloud fields of keyframes ``idx``, in ``SHARDED_FIELDS``
    order: plain indexing, or with a ``mesh`` one ``gather_rows`` of all
    six."""
    return mesh_mod.gather_rows(
        tuple(getattr(kf, f) for f in SHARDED_FIELDS), idx, mesh)


def build_submap(config: PipelineConfig, kf: KeyframeStore, mesh=None):
    """Union of the selected keyframe clouds in the world frame,
    voxel-decimated (extractSurroundingKeyFrames; corner 0.2, surf+outlier
    0.3, mO.cpp:1223-1230).  Loop closure ON: the ``submap_recent_num``
    most recent keyframes (mO.cpp:1127-1166 deque path).  OFF: the nearest
    keyframes within ``submap_search_radius`` of the latest pose
    (mO.cpp:1167-1222), capped at the same count to keep shapes static.
    With a ``mesh`` the clouds come from banks sharded over 'kf'."""
    cap, m = config.cap, config.mapping
    R = m.submap_recent_num
    dev = kf.poses6.device
    if config.loop.enabled:
        back = kf.count.to(torch.int64) - 1 - torch.arange(R, device=dev)
        idx = torch.clamp(back, 0, cap.max_keyframes - 1)
        sel_ok = back >= 0
    else:
        last = torch.clamp(kf.count.to(torch.int64) - 1, min=0).reshape(1)
        cur = kf.poses6[last, 3:6]                               # (1,3)
        d = torch.linalg.vector_norm(kf.poses6[:, 3:6] - cur, dim=-1)
        ok = (torch.arange(cap.max_keyframes, device=dev) < kf.count) & \
             (d < m.submap_search_radius)
        score = torch.where(ok, -d, -torch.inf)
        score_k, idx = _top_k(score, R)
        sel_ok = torch.isfinite(score_k)

    poses = se3.pose6_to_mat(kf.poses6[idx])                     # (R,4,4)

    def world(pts, mask):
        out = (poses[:, None, :3, :3] @ pts[..., None])[..., 0] \
            + poses[:, None, :3, 3]
        return out, mask & sel_ok[:, None]

    c, cm, s, sm, o, om = keyframe_clouds(kf, idx, mesh)
    c_pts, c_mask = world(c, cm)
    s_pts, s_mask = world(s, sm)
    o_pts, o_mask = world(o, om)

    corner, corner_mask = voxel.voxel_decimate(
        c_pts.reshape(-1, 3), c_mask.reshape(-1), m.corner_leaf,
        cap.submap_corner_pad)
    surf_all = torch.cat([s_pts.reshape(-1, 3), o_pts.reshape(-1, 3)])
    surf_allm = torch.cat([s_mask.reshape(-1), o_mask.reshape(-1)])
    surf, surf_mask = voxel.voxel_decimate(
        surf_all, surf_allm, m.surf_leaf, cap.submap_surf_pad)
    return corner, corner_mask, surf, surf_mask


# The per-query fits below sum over the k neighbours in a FIXED order (a
# running sum, and a running FMA for the outer products), which is also
# the order the JAX package's einsums take on the CPU.  The plane fit
# solves its 3x3 normal equations in fp32 with points 10-30 m from the
# origin, where a one-ulp change of A^T A moves the normal by up to ~1e-2;
# the fixed order keeps the port's fits equal to the reference's on the
# CPU instead of at the mercy of a reduction's blocking.

def _sum_k(x):
    """(Q,k,...) -> (Q,...), summed over k in order."""
    s = x[:, 0]
    for j in range(1, x.shape[1]):
        s = s + x[:, j]
    return s


def _outer_sum_k(x):
    """(Q,k,3) -> (Q,3,3) sum_j x_j x_j^T, as a running FMA over k."""
    a, b = x[:, :, :, None], x[:, :, None, :]
    s = a[:, 0] * b[:, 0]
    for j in range(1, x.shape[1]):
        s = torch.addcmul(s, a[:, j], b[:, j])
    return s


def _corner_geometry(p_w, submap, knn5, qcnt, m):
    """Line fits from 5-NN (cornerOptimization, mO.cpp:1265-1346).
    Returns (a, b, valid): the two virtual line points per query."""
    idx, sqd = knn5(p_w, qcnt)
    nn_ok = sqd[:, m.knn - 1] < m.max_nn_sq_dist
    pts = submap[idx]                              # (Q,5,3)
    center = _sum_k(pts) / m.knn
    d = pts - center[:, None]
    cov = _outer_sum_k(d) / m.knn
    evals, dirv = solver.sym3_eig(cov)
    is_line = evals[:, 2] > m.corner_eig_ratio * evals[:, 1]
    return center + 0.1 * dirv, center - 0.1 * dirv, nn_ok & is_line


def _surf_geometry(p_w, submap, knn5, qcnt, m):
    """Plane fits from 5-NN (surfOptimization, mO.cpp:1348-1399).
    Returns (n, d, valid): unit plane normal + offset per query."""
    idx, sqd = knn5(p_w, qcnt)
    nn_ok = sqd[:, m.knn - 1] < m.max_nn_sq_dist
    pts = submap[idx]                              # (Q,5,3)
    AtA = _outer_sum_k(pts)
    Atb = -_sum_k(pts)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    n = solver.solve3(AtA + 1e-8 * eye[None], Atb)
    norm = torch.clamp(torch.linalg.vector_norm(n, dim=-1), min=1e-9)
    nu = n / norm[:, None]
    dof = 1.0 / norm
    pd = (torch.einsum("qki,qi->qk", pts, nu) + dof[:, None]).abs()
    plane_ok = (pd <= m.plane_fit_tol).all(-1)
    return nu, dof, nn_ok & plane_ok


def scan_to_map(config: PipelineConfig, T_guess: torch.Tensor,
                corner_q: torch.Tensor, corner_qmask: torch.Tensor,
                surf_q: torch.Tensor, surf_qmask: torch.Tensor,
                submap_c: torch.Tensor, submap_cm: torch.Tensor,
                submap_s: torch.Tensor, submap_sm: torch.Tensor):
    """6-DOF LM refinement (scan2MapOptimization, mO.cpp:1501-1522).
    Returns the refined world pose (4,4)."""
    m = config.mapping
    dev = T_guess.device
    enough = (submap_cm.sum() > 10) & (submap_sm.sum() > m.min_submap_points)

    # Prefix-compact both query sets once: the kernel then skips query
    # rows past the live count.
    corner_q, corner_qmask = compact(corner_q, corner_qmask,
                                     corner_q.shape[0])
    surf_q, surf_qmask = compact(surf_q, surf_qmask, surf_q.shape[0])
    qcnt_c = corner_qmask.sum(dtype=torch.int32).reshape(1)
    qcnt_s = surf_qmask.sum(dtype=torch.int32).reshape(1)

    knn_c = _make_knn5(submap_c, submap_cm, m)
    knn_s = _make_knn5(submap_s, submap_sm, m)
    nq = corner_q.shape[0]
    depth = torch.linalg.vector_norm(surf_q, dim=-1)

    def research(T):
        la, lb, c_ok = _corner_geometry(_transform(T, corner_q), submap_c,
                                        knn_c, qcnt_c, m)
        nu, dof, s_ok = _surf_geometry(_transform(T, surf_q), submap_s,
                                       knn_s, qcnt_s, m)
        return la, lb, c_ok & corner_qmask, nu, dof, s_ok & surf_qmask

    def iteration(it, state):
        T, Pm, degen, geom = state
        if it % m.research_every == 0 and it > 0:
            geom = research(T)
        la, lb, c_ok, nu, dof, s_ok = geom

        def resid(delta):
            Td = se3.se3_exp(delta) @ T
            pc = _transform(Td, corner_q)
            ps = _transform(Td, surf_q)
            cr = torch.linalg.cross(pc - la, pc - lb)
            rc = torch.linalg.vector_norm(cr, dim=-1) / torch.clamp(
                torch.linalg.vector_norm(la - lb, dim=-1), min=1e-9)
            rs = (ps * nu).sum(-1) + dof
            return torch.cat([rc, rs])

        delta0 = torch.zeros(6, dtype=torch.float32, device=dev)
        r = resid(delta0)
        J = jacfwd(resid)(delta0)
        # Robust weights (mO.cpp:1332,1384); surf gets the depth discount.
        wc = solver.robust_weight(r[:nq].abs(), m.robust_slope,
                                  m.robust_min_weight, True)
        ws_raw = 1.0 - m.robust_slope * r[nq:].abs() / torch.sqrt(
            torch.clamp(depth, min=1e-6))
        ws = torch.where(ws_raw > m.robust_min_weight, ws_raw, 0.0)
        w = torch.cat([wc * c_ok, ws * s_ok])

        n_sel = (w > 0).sum()
        delta, H, _ = solver.gauss_newton_step(J, r, w, damping=1e-6)
        if it == 0:      # degeneracy eigen once (mO.cpp:1450-1477)
            Pm, degen = solver.degeneracy_projector(H, m.eig_threshold)
        delta = torch.where(degen, Pm @ delta, delta)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        few = n_sel < m.min_correspondences           # mO.cpp:1410
        delta = torch.where(few, 0.0, delta)
        T = se3.se3_exp(delta) @ T
        done = solver.converged(delta[:3], delta[3:], m.delta_rot_deg,
                                m.delta_trans_cm) | few
        return done, (T, Pm, degen, geom)

    state = (T_guess, torch.eye(6, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev),
             research(T_guess))
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for it in range(m.max_iterations):
        new_done, new_state = iteration(it, state)
        state = solver.freeze(done, state, new_state)
        done = done | new_done
    return torch.where(enough, state[0], T_guess)


def downsample_scan(config: PipelineConfig,
                    corner: torch.Tensor, corner_mask: torch.Tensor,
                    surf: torch.Tensor, surf_mask: torch.Tensor,
                    outlier: torch.Tensor, outlier_mask: torch.Tensor):
    """Current-scan voxel DS (downsampleCurrentScan, mO.cpp:1233-1263)."""
    cap, m = config.cap, config.mapping
    c, cm = voxel.voxel_downsample_hash(corner, corner_mask, m.corner_leaf,
                                        cap.kf_corner_pad, table_bits=14)
    s, sm = voxel.voxel_downsample_hash(surf, surf_mask, m.surf_leaf,
                                        cap.kf_surf_pad, table_bits=14)
    o, om = voxel.voxel_downsample_hash(outlier, outlier_mask,
                                        m.outlier_leaf, cap.kf_outlier_pad,
                                        table_bits=14)
    return c, cm, s, sm, o, om


def keyframe_rows(config: PipelineConfig, kf: KeyframeStore,
                  pose: torch.Tensor, time: torch.Tensor,
                  corner: torch.Tensor, corner_mask: torch.Tensor,
                  surf: torch.Tensor, surf_mask: torch.Tensor,
                  outlier: torch.Tensor, outlier_mask: torch.Tensor,
                  odom_pose: torch.Tensor | None = None, mesh=None):
    """What a keyframe append writes, without writing it: the slot (1,)
    (``count``, or the last slot of a full bank), whether the bank has room,
    and one new row per bank field, in the store's field order (a full
    bank's row is the slot's own contents).  Reads the bank only, so it
    runs under ``torch.func.vmap``; the caller writes the rows.  With a
    ``mesh`` the cloud fields are this rank's blocks of sharded banks."""
    K = config.cap.max_keyframes
    room = kf.count < K
    i = torch.clamp(kf.count.to(torch.int64), max=K - 1).reshape(1)
    prev = se3.pose6_to_mat(kf.poses6[torch.clamp(i - 1, min=0)][0])
    z = torch.where(i[0] == 0, pose, se3.mat_inv(prev) @ pose)
    if odom_pose is None:
        odom_pose = pose
    new = dict(poses6=se3.mat_to_pose6(pose), times=time, corner=corner,
               corner_mask=corner_mask, surf=surf, surf_mask=surf_mask,
               outlier=outlier, outlier_mask=outlier_mask, odom_z=z,
               odom_pose=odom_pose)
    rows = {name: torch.where(room, new[name], mesh_mod.local_row(
        getattr(kf, name), i, mesh if name in SHARDED_FIELDS else None))
            for name in KeyframeStore._fields[:-1]}
    return i, room, rows


def insert_keyframe(config: PipelineConfig, kf: KeyframeStore,
                    should: torch.Tensor, pose: torch.Tensor,
                    time: torch.Tensor,
                    corner: torch.Tensor, corner_mask: torch.Tensor,
                    surf: torch.Tensor, surf_mask: torch.Tensor,
                    outlier: torch.Tensor, outlier_mask: torch.Tensor,
                    odom_pose: torch.Tensor | None = None, mesh=None):
    """Guarded keyframe append (saveKeyFramesAndFactor, mO.cpp:1525-1639),
    IN PLACE on the bank tensors.  The candidate is always written at slot
    ``count`` (invisible: readers mask by ``< count``) and ``should`` only
    bumps the count; a full bank rewrites its last slot with its own
    contents and drops the keyframe.  With a ``mesh`` a cloud row is
    written only by the rank that owns the slot.  Returns (kf, inserted)."""
    i, room, rows = keyframe_rows(config, kf, pose, time, corner,
                                  corner_mask, surf, surf_mask, outlier,
                                  outlier_mask, odom_pose, mesh)
    for name, row in rows.items():
        mesh_mod.owner_write(getattr(kf, name), i, row,
                             mesh if name in SHARDED_FIELDS else None)
    inserted = should & room
    kf = kf._replace(count=kf.count + inserted.to(torch.int32))
    return kf, inserted


def should_insert_keyframe(config: PipelineConfig, last_kf_pose: torch.Tensor,
                           pose: torch.Tensor) -> torch.Tensor:
    """Keyframe if moved >= keyframe_dist (mO.cpp:1531-1538)."""
    d = torch.linalg.vector_norm(pose[:3, 3] - last_kf_pose[:3, 3])
    return d >= config.mapping.keyframe_dist
