"""Scan-to-scan odometry (port of ``sc_lego_loam_tpu/odometry.py``;
reference featureAssociation.cpp).

Trust-region LM on an se(3) twist over point-to-line (corner) and
point-to-plane (surf) residuals, with correspondences re-searched every
``research_every`` iterations by brute force over packed
(quantized distance | index) int32 keys.  Jacobians are forward-mode
(``torch.func.jacfwd``).  ``joint_6dof`` solves all six DOF together;
without it the reference's two stages run: surf features solve
[roll, pitch, tz], then corner features [yaw, tx, ty] (fA.cpp:1270-1478).

Control flow never branches on a device value: an LM loop runs its fixed
iteration count and freezes the state with ``torch.where`` once converged,
and the first-scan initialization is a ``torch.where`` between the tracked
and the initializing result.  An LM loop reads nothing on the host: the
degeneracy guard's eigendecomposition is ``ops/symeig`` (one kernel a scan
jointly, 6x6; two in two stages, 3x3), so the step can be captured in a
CUDA graph.
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


def _corner_terms(sharp, corner_t, ocfg):
    """(research(xi) -> corres, residual_fns(corres) -> tuple of (xi -> r))
    of the corner features; ``corres[-1]`` is the valid mask."""

    def research(xi):
        return _find_corner(_apply(xi, sharp.xyz), sharp.mask, corner_t, ocfg)

    def residual_fns(cc):
        j, l2, _ = cc
        a, b = corner_t.xyz[j], corner_t.xyz[l2]
        return (lambda x: _corner_residual(x, sharp.xyz, a, b),)

    return research, residual_fns


def _surf_terms(flat, surf_t, ocfg):
    """The same for the surf features."""

    def research(xi):
        return _find_surf(_apply(xi, flat.xyz), flat.mask, surf_t, ocfg)

    def residual_fns(sc):
        j, l2, l3, _ = sc
        a, b, c = surf_t.xyz[j], surf_t.xyz[l2], surf_t.xyz[l3]
        return (lambda x: _surf_residual(x, flat.xyz, a, b, c),)

    return research, residual_fns


def _both_terms(corner_terms, surf_terms):
    """Corner and surf terms as one: residual functions side by side (the
    loop differentiates each on its own), valid masks joined."""
    corner_research, corner_fns = corner_terms
    surf_research, surf_fns = surf_terms

    def research(xi):
        cc, sc = corner_research(xi), surf_research(xi)
        return cc, sc, torch.cat([cc[-1], sc[-1]])

    def residual_fns(corres):
        return corner_fns(corres[0]) + surf_fns(corres[1])

    return research, residual_fns


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _lm_loop(xi0, xi_anchor, tube, param_idx, terms, ocfg):
    """Trust-region LM over the twist components ``param_idx`` on the
    residuals of ``terms`` (``_joint_loop`` and ``_stage_loop`` of the JAX
    package): adaptive accept / reject LM where the reference takes fixed
    5 % steps (fA.cpp:1321).  All six components: the joint solve, which
    keeps a large yaw error from poisoning roll / pitch / z through bad
    correspondences; three: one stage of the reference's split.
    Returns (xi, number of valid correspondences at the solution)."""
    research, residual_fns = terms
    dev, P = xi0.device, len(param_idx)
    eye = torch.eye(P, dtype=xi0.dtype, device=dev)
    zero = torch.zeros((), dtype=xi0.dtype, device=dev)

    def iteration(it, state):
        xi, corres, Pm, degen, lam = state
        if it % ocfg.research_every == 0 and it > 0:
            corres = research(xi)
        fns = residual_fns(corres)

        def residual(x):
            return _cat([f(x) for f in fns])

        r = residual(xi)
        J = _cat([jacfwd(f)(xi) for f in fns])                   # (N,6)
        if P < 6:   # columns by slicing: an index list is a host copy
            J = torch.stack([J[:, i] for i in param_idx], 1)
        w = solver.robust_weight(r.abs(), ocfg.robust_slope,
                                 ocfg.robust_min_weight,
                                 it >= ocfg.robust_after_iter)
        w = w * corres[-1].to(r.dtype)
        Jw = J * w[:, None]
        H = Jw.T @ J
        g = Jw.T @ r
        Hd = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye
        delta = -solver.solve_spd(Hd, g)
        if it == 0:      # degeneracy eigen once (fA.cpp:1329-1356)
            Pm, degen = solver.degeneracy_projector(H, ocfg.eig_threshold)
        delta = torch.where(degen, Pm @ delta, delta)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        if P < 6:
            parts = [zero] * 6
            for n, i in enumerate(param_idx):
                parts[i] = delta[n]
            delta = torch.stack(parts)
        delta = _clamp_step(delta, ocfg)
        xi_new = _clamp_to_prior(xi + delta, xi_anchor, tube)

        cost_old = (w * r * r).sum()
        r_new = residual(xi_new)
        cost_new = (w * r_new * r_new).sum()
        accept = (cost_new < cost_old) & torch.isfinite(cost_new)
        xi = torch.where(accept, xi_new, xi)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-5, 1e4)
        done = accept & solver.converged(delta[:3], delta[3:],
                                         ocfg.delta_rot_deg,
                                         ocfg.delta_trans_cm)
        return done, (xi, corres, Pm, degen, lam)

    state = (xi0, research(xi0), eye,
             torch.zeros((), dtype=torch.bool, device=dev),
             torch.full((), 1e-3, dtype=torch.float32, device=dev))
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for it in range(ocfg.max_iterations):
        new_done, new_state = iteration(it, state)
        state = solver.freeze(done, state, new_state)
        done = done | new_done
    return state[0], state[1][-1].sum()


def step(config: PipelineConfig, state: OdometryState, feats: FeatureSet,
         xi_prior: torch.Tensor | None = None):
    """One odometry tick.  Returns (new_state, world_pose (4,4), rel twist).

    ``xi_prior``: optional initial-guess twist (the IMU dead-reckoned
    motion, updateInitialGuess fA.cpp:1639-1664); defaults to the
    constant-velocity prior (previous twist)."""
    ocfg = config.odom
    xi0 = state.motion if xi_prior is None else xi_prior
    # The trust tube is a DYNAMICS bound (bounded rate change per scan), so
    # it stays anchored at the previous scan's ESTIMATED motion, never at
    # the initial guess.  With a prior its radius grows by the prior's
    # deviation from that motion: a measured rate change larger than the
    # dynamics bound must stay reachable.
    xi_anchor = state.motion
    tube = (ocfg.max_rot_from_prior, ocfg.max_trans_from_prior)
    if xi_prior is not None:
        dprior = xi_prior - state.motion
        tube = (tube[0] + torch.linalg.vector_norm(dprior[:3]),
                tube[1] + torch.linalg.vector_norm(dprior[3:]))
    if ocfg.joint_6dof and ocfg.dense_queries:
        def subsample(fc: FeatureCloud, cap: int) -> FeatureCloud:
            # Strided static-shape subsample of the padded bank.
            k = max(1, fc.xyz.shape[0] // cap)
            return FeatureCloud(*(a[::k][:cap] for a in fc))

        sharp = subsample(feats.less_sharp, ocfg.query_corner_cap)
        flat = subsample(feats.less_flat, ocfg.query_surf_cap)
    else:
        sharp, flat = feats.sharp, feats.flat
    corner_terms = _corner_terms(sharp, state.corner_last, ocfg)
    surf_terms = _surf_terms(flat, state.surf_last, ocfg)

    if ocfg.joint_6dof:
        xi2, n_corres = _lm_loop(xi0, xi_anchor, tube, range(6),
                                 _both_terms(corner_terms, surf_terms), ocfg)
        enough = n_corres >= ocfg.min_total_corres
    else:
        # Reference two-stage split: surf -> [roll, pitch, tz], then
        # corner -> [yaw, tx, ty]; gated on the feature counts.
        enough = (sharp.mask.sum() >= ocfg.min_feature_points) & \
                 (flat.mask.sum() >= ocfg.min_surf_points)
        xi1, _ = _lm_loop(xi0, xi_anchor, tube, (0, 1, 5), surf_terms, ocfg)
        xi2, _ = _lm_loop(xi1, xi_anchor, tube, (2, 3, 4), corner_terms, ocfg)
    xi = torch.where(enough, xi2, xi0)
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
