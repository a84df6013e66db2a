"""Scan-to-scan odometry (port of ``sc_lego_loam_tpu/odometry.py``;
reference featureAssociation.cpp).

Joint 6-DOF trust-region LM on an se(3) twist over point-to-line (corner)
and point-to-plane (surf) residuals, with correspondences re-searched every
``research_every`` iterations by brute force over packed
(quantized distance | index) int32 keys.  Jacobians are forward-mode
(``torch.func.jacfwd``).

Control flow never reads a device value on the host: the LM loop runs its
fixed iteration count and freezes the state with ``torch.where`` once
converged, and the first-scan initialization is a ``torch.where`` between
the tracked and the initializing result.  The reference's two-stage 3-DOF
split (``joint_6dof=False``) is not ported yet and raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from .config import PipelineConfig

from .ops import residuals, solver
from .ops.features import FeatureCloud, FeatureSet, empty_cloud
from .utils import se3

_BIG = 1e18


class OdometryState(NamedTuple):
    corner_last: FeatureCloud   # prev less-sharp, in prev scan-end frame
    surf_last: FeatureCloud     # prev less-flat, in prev scan-end frame
    pose: torch.Tensor          # (4,4) world_from_scan_end
    motion: torch.Tensor        # (6,) last relative twist (const-vel prior)
    initialized: torch.Tensor   # () bool


def init_state(config: PipelineConfig, device) -> OdometryState:
    cap = config.cap
    return OdometryState(
        corner_last=empty_cloud(cap.less_sharp_pad, device),
        surf_last=empty_cloud(cap.less_flat_pad, device),
        pose=torch.eye(4, dtype=torch.float32, device=device),
        motion=torch.zeros(6, dtype=torch.float32, device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
    )


def _sqdist(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(Q,3),(T,3) -> (Q,T) squared distances by the norm expansion."""
    qq = (q * q).sum(-1)[:, None]
    tt = (t * t).sum(-1)[None, :]
    return torch.clamp(qq + tt - 2.0 * (q @ t.T), min=0.0)


# Packed keys: each ring relation is ONE min-reduction over the (Q,T) key
# matrix.  Quantization (over [0, 64] m^2) only re-breaks exact-distance
# ties.
_NN_MAXKEY = 2 ** 31 - 1
_NN_MAX_SQ = 64.0


def _nn_idx_bits(T: int) -> int:
    bits = max(1, (T - 1).bit_length())
    if bits > 24:
        raise ValueError(f"target pad {T} leaves <7 distance bits")
    return bits


def _packed_keys(q_xyz, tgt: FeatureCloud):
    """(Q,T) packed int32 keys; invalid targets hold MAXKEY."""
    T = tgt.xyz.shape[0]
    bits = _nn_idx_bits(T)
    d = _sqdist(q_xyz, tgt.xyz)
    scale = float((1 << (31 - bits)) - 4) / _NN_MAX_SQ
    dq = torch.clamp(d * scale, 0, float((1 << (31 - bits)) - 2)
                     ).to(torch.int32)
    tidx = torch.arange(T, dtype=torch.int32, device=d.device)[None, :]
    key = (dq << bits) | tidx
    return torch.where(tgt.mask[None, :], key, _NN_MAXKEY), (scale, bits, T)


def _unpack(key, scale_bits):
    """Key -> (squared distance, target index).  A MAXKEY (no target) gives
    distance _BIG and an index clamped into the bank, as a JAX gather
    clamps it."""
    scale, bits, T = scale_bits
    dd = (key >> bits).to(torch.float32) / scale
    idx = torch.clamp((key & ((1 << bits) - 1)).to(torch.int64), max=T - 1)
    return torch.where(key == _NN_MAXKEY, _BIG, dd), idx


def _find_corner(q_xyz, q_mask, tgt: FeatureCloud, ocfg):
    """Edge correspondences (fA.cpp:1044-1153): nearest neighbor j plus the
    nearest point l2 in a *different* ring within +-near_ring_span."""
    key, scale = _packed_keys(q_xyz, tgt)
    k1 = key.amin(-1)
    dj, j = _unpack(k1, scale)
    ring_j = tgt.ring[j]
    dr = (tgt.ring[None, :] - ring_j[:, None]).abs()
    m2 = (dr > 0) & (dr <= ocfg.near_ring_span)
    k2 = torch.where(m2, key, _NN_MAXKEY).amin(-1)
    dl2, l2 = _unpack(k2, scale)
    valid = q_mask & (dj < ocfg.nearest_sq_dist) & (dl2 < ocfg.nearest_sq_dist)
    return j, l2, valid


def _find_surf(q_xyz, q_mask, tgt: FeatureCloud, ocfg):
    """Planar correspondences (fA.cpp:1155-1268): nearest j, nearest l2 in
    the SAME ring (excluding j), nearest l3 in a different ring within
    +-near_ring_span."""
    key, scale = _packed_keys(q_xyz, tgt)
    k1 = key.amin(-1)
    dj, j = _unpack(k1, scale)
    ring_j = tgt.ring[j]
    same = tgt.ring[None, :] == ring_j[:, None]
    k2 = torch.where(same & (key != k1[:, None]), key, _NN_MAXKEY).amin(-1)
    dl2, l2 = _unpack(k2, scale)
    dr = (tgt.ring[None, :] - ring_j[:, None]).abs()
    m3 = (dr > 0) & (dr <= ocfg.near_ring_span)
    k3 = torch.where(m3, key, _NN_MAXKEY).amin(-1)
    dl3, l3 = _unpack(k3, scale)
    thr = ocfg.nearest_sq_dist
    valid = q_mask & (dj < thr) & (dl2 < thr) & (dl3 < thr)
    return j, l2, l3, valid


def _apply(xi, pts):
    """exp(xi) p — the rigid scan-to-prev-end transform (the solver is
    purely rigid; de-skew happens once per scan before it)."""
    T = se3.se3_exp(xi)
    return pts @ T[:3, :3].T + T[:3, 3]


def deskew_with_twist(xi, pts, s):
    """Constant-twist de-skew into the scan-END frame:
    p_end = exp((s-1) xi) p, with ``xi`` the carried previous twist."""
    T = se3.se3_exp((s - 1.0)[:, None] * xi[None, :])    # (N,4,4)
    return (T[:, :3, :3] @ pts[..., None])[..., 0] + T[:, :3, 3]


def _corner_residual(xi, q, a, b):
    return residuals.point_to_line(_apply(xi, q), a, b)


def _surf_residual(xi, q, a, b, c):
    return residuals.point_to_plane(_apply(xi, q), a, b, c)


def _clamp_step(delta, ocfg):
    """Trust-region clamp of one 6-twist step (see OdometryConfig)."""
    wn = torch.linalg.vector_norm(delta[:3])
    vn = torch.linalg.vector_norm(delta[3:])
    s = torch.clamp(torch.minimum(
        ocfg.max_step_rot / torch.clamp(wn, min=1e-12),
        ocfg.max_step_trans / torch.clamp(vn, min=1e-12)), max=1.0)
    return delta * s


def _clamp_to_prior(xi_new, xi_prior, bounds):
    """Per-scan trust tube around the motion prior."""
    rot_bound, trans_bound = bounds
    d = xi_new - xi_prior
    wn = torch.linalg.vector_norm(d[:3])
    vn = torch.linalg.vector_norm(d[3:])
    s = torch.clamp(torch.minimum(
        rot_bound / torch.clamp(wn, min=1e-12),
        trans_bound / torch.clamp(vn, min=1e-12)), max=1.0)
    return xi_prior + d * s


def _joint_loop(xi0, xi_anchor, tube, sharp, flat, corner_t, surf_t, ocfg):
    """Joint 6-DOF LM over corner + surf residuals (odometry._joint_loop of
    the JAX package).  Returns (xi, n_valid_correspondences)."""

    def corner_research(xi):
        return _find_corner(_apply(xi, sharp.xyz), sharp.mask, corner_t, ocfg)

    def surf_research(xi):
        return _find_surf(_apply(xi, flat.xyz), flat.mask, surf_t, ocfg)

    def research(xi):
        return corner_research(xi), surf_research(xi)

    def corner_fn(cc):
        j, l2, _ = cc
        a, b = corner_t.xyz[j], corner_t.xyz[l2]
        return lambda x: _corner_residual(x, sharp.xyz, a, b)

    def surf_fn(sc):
        j, l2, l3, _ = sc
        a, b, c = surf_t.xyz[j], surf_t.xyz[l2], surf_t.xyz[l3]
        return lambda x: _surf_residual(x, flat.xyz, a, b, c)

    eye6 = torch.eye(6, dtype=xi0.dtype, device=xi0.device)

    def iteration(it, state):
        xi, corres, Pm, degen, lam = state
        if it % ocfg.research_every == 0 and it > 0:
            corres = research(xi)
        cc, sc = corres
        cf, sf = corner_fn(cc), surf_fn(sc)
        r = torch.cat([cf(xi), sf(xi)])
        J = torch.cat([jacfwd(cf)(xi), jacfwd(sf)(xi)])
        valid = torch.cat([cc[-1], sc[-1]])
        w = solver.robust_weight(r.abs(), ocfg.robust_slope,
                                 ocfg.robust_min_weight,
                                 it >= ocfg.robust_after_iter)
        w = w * valid.to(r.dtype)
        Jw = J * w[:, None]
        H = Jw.T @ J
        g = Jw.T @ r
        Hd = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
        delta = -solver.solve_spd(Hd, g)
        if it == 0:      # degeneracy eigh once (fA.cpp:1329-1356)
            Pm, degen = solver.degeneracy_projector(H, ocfg.eig_threshold)
        delta = torch.where(degen, Pm @ delta, delta)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        delta = _clamp_step(delta, ocfg)
        xi_new = _clamp_to_prior(xi + delta, xi_anchor, tube)

        cost_old = (w * r * r).sum()
        r_new = torch.cat([cf(xi_new), sf(xi_new)])
        cost_new = (w * r_new * r_new).sum()
        accept = (cost_new < cost_old) & torch.isfinite(cost_new)
        xi = torch.where(accept, xi_new, xi)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-5, 1e4)
        done = accept & solver.converged(delta[:3], delta[3:],
                                         ocfg.delta_rot_deg,
                                         ocfg.delta_trans_cm)
        return done, (xi, corres, Pm, degen, lam)

    state = (xi0, research(xi0), eye6,
             torch.zeros((), dtype=torch.bool, device=xi0.device),
             torch.full((), 1e-3, dtype=torch.float32, device=xi0.device))
    done = torch.zeros((), dtype=torch.bool, device=xi0.device)
    for it in range(ocfg.max_iterations):
        new_done, new_state = iteration(it, state)
        state = solver.freeze(done, state, new_state)
        done = done | new_done
    xi, (cc, sc) = state[0], state[1]
    return xi, cc[-1].sum() + sc[-1].sum()


def step(config: PipelineConfig, state: OdometryState, feats: FeatureSet):
    """One odometry tick.  Returns (new_state, world_pose (4,4), rel twist).
    The constant-velocity prior (previous twist) is the initial guess."""
    ocfg = config.odom
    if not ocfg.joint_6dof:
        raise NotImplementedError(
            "the two-stage 3-DOF odometry (joint_6dof=False) is not ported")
    xi0 = state.motion
    tube = (ocfg.max_rot_from_prior, ocfg.max_trans_from_prior)
    if ocfg.dense_queries:
        def subsample(fc: FeatureCloud, cap: int) -> FeatureCloud:
            # Strided static-shape subsample of the padded bank.
            k = max(1, fc.xyz.shape[0] // cap)
            return FeatureCloud(*(a[::k][:cap] for a in fc))

        sharp = subsample(feats.less_sharp, ocfg.query_corner_cap)
        flat = subsample(feats.less_flat, ocfg.query_surf_cap)
    else:
        sharp, flat = feats.sharp, feats.flat

    xi2, n_corres = _joint_loop(xi0, xi0, tube, sharp, flat,
                                state.corner_last, state.surf_last, ocfg)
    xi = torch.where(n_corres >= ocfg.min_total_corres, xi2, xi0)
    xi = torch.where(torch.isfinite(xi), xi, 0.0)
    # First scan: no targets yet — keep the pose, zero motion.
    xi = torch.where(state.initialized, xi, 0.0)
    pose = state.pose @ se3.se3_exp(xi)

    # Our clouds already live in the scan-end frame, so they become the
    # next frame's targets as-is (TransformToEnd, fA.cpp:885-953).
    new = OdometryState(
        corner_last=feats.less_sharp, surf_last=feats.less_flat,
        pose=pose, motion=xi,
        initialized=torch.ones((), dtype=torch.bool, device=xi.device))
    return new, pose, xi
