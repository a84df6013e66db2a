"""The plain reference: NumPy in float64, importing nothing of the program.

It works out again, from the drive's parameters, what the program's
answers should be, and measures how far they lie from it:

- the ground truth: the scan-end pose of every scan, from the mix's
  trajectory formula (``ground_truth``);
- the error of each published pose's step from the scan before against
  the true step (``scan_steps``), of each keyframe's step
  (``keyframe_steps``) and of each accepted loop factor
  (``factor_errors``);
- how far a pose or a factor is from a rigid transform (``rigidity``);
- the loop-corrected keyframe graph against a float64 robust Gauss-Newton
  re-solve of the same graph (``graph_gap``): the program's odometry and
  loop factors, the prior, variances and Cauchy kernel the configuration
  states;
- the control, this reference in the program's place in TF32
  (``control_poses``, ``control_factors``);
- ATE after a rigid Umeyama alignment, loop precision and recall.

``judge.py`` decides which of these ``correct`` compares.  Every error is
frame-free (relative poses), so the program's map frame, which starts at
its first scan, needs no alignment.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse
import scipy.sparse.linalg

SCAN_PERIOD = 0.1


# ---- SE(3) in float64 -------------------------------------------------------

def hat(w):
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_exp(w):
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    small = th < 1e-12
    ths = np.where(small, 1.0, th)
    K = hat(w) / ths
    R = np.eye(3) + np.sin(ths) * K + (1 - np.cos(ths)) * (K @ K)
    return np.where(small, np.eye(3) + hat(w), R)


def so3_log(R):
    """Principal log by atan2 (accurate at small angles, where arccos of
    the trace is not)."""
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = np.linalg.norm(w, axis=-1)                 # 2 sin(th)
    c2 = np.trace(R, axis1=-2, axis2=-1) - 1        # 2 cos(th)
    th = np.arctan2(s2, c2)
    f = np.where(s2 < 1e-12, 0.5, th / np.where(s2 < 1e-12, 1.0, s2))
    return f[..., None] * w


def se3_exp(xi):
    """(...,6) twist [w, v] -> (...,4,4)."""
    w, v = xi[..., :3], xi[..., 3:]
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    small = th < 1e-8
    ths = np.where(small, 1.0, th)
    W = hat(w)
    b = np.where(small, 0.5 - th ** 2 / 24, (1 - np.cos(ths)) / ths ** 2)
    c = np.where(small, 1 / 6 - th ** 2 / 120,
                 (ths - np.sin(ths)) / ths ** 3)
    V = np.eye(3) + b * W + c * (W @ W)
    T = np.zeros(xi.shape[:-1] + (4, 4))
    T[..., :3, :3] = so3_exp(w)
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def se3_log(T):
    """(...,4,4) -> (...,6) twist [w, v] (the program's convention)."""
    w = so3_log(T[..., :3, :3])
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    small = th < 1e-6
    ths = np.where(small, 1.0, th)
    W = hat(w)
    coef = np.where(small, 1 / 12 + th ** 2 / 720,
                    1 / ths ** 2 - (1 + np.cos(ths)) / (2 * ths * np.sin(ths)))
    Vinv = np.eye(3) - 0.5 * W + coef * (W @ W)
    return np.concatenate([w, (Vinv @ T[..., :3, 3:4])[..., 0]], -1)


def inv(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = np.zeros_like(T)
    out[..., :3, :3] = np.swapaxes(R, -1, -2)
    out[..., :3, 3] = -(np.swapaxes(R, -1, -2) @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def pose6_to_mat(p):
    """(roll, pitch, yaw, x, y, z) -> 4x4 with R = Rz(yaw) Ry(pitch)
    Rx(roll)."""
    r, pt, y = p[..., 0], p[..., 1], p[..., 2]
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(pt), np.sin(pt),
                              np.cos(y), np.sin(y))
    T = np.zeros(p.shape[:-1] + (4, 4))
    T[..., 0, :3] = np.stack([cy * cp, cy * sp * sr - sy * cr,
                              cy * sp * cr + sy * sr], -1)
    T[..., 1, :3] = np.stack([sy * cp, sy * sp * sr + cy * cr,
                              sy * sp * cr - cy * sr], -1)
    T[..., 2, :3] = np.stack([-sp, cp * sr, cp * cr], -1)
    T[..., :3, 3] = p[..., 3:6]
    T[..., 3, 3] = 1.0
    return T


def pose_error(est_rel, true_rel):
    """Translation (m) and rotation (deg) of true^-1 est, batched."""
    E = inv(true_rel) @ est_rel
    return (np.linalg.norm(E[..., :3, 3], axis=-1),
            np.degrees(np.linalg.norm(so3_log(E[..., :3, :3]), axis=-1)))


# ---- ground truth -----------------------------------------------------------

def trajectory(traffic: dict, n: int) -> np.ndarray:
    """The mix's first ``n`` poses (one a scan), float64."""
    s = np.arange(n, dtype=np.float64) * (2 * math.pi
                                          / traffic["scans_per_lap"])
    R, h = traffic["radius"], traffic["height"]
    if traffic["trajectory"] == "figure8":
        x, y = R * np.sin(s), 0.5 * R * np.sin(2 * s)
        dx, dy = R * np.cos(s), R * np.cos(2 * s)
    elif traffic["trajectory"] == "cloverleaf":
        q = traffic["petals"] / 2.0
        r, dr = R * np.sin(q * s), R * q * np.cos(q * s)
        x, y = r * np.cos(s), r * np.sin(s)
        dx, dy = dr * np.cos(s) - r * np.sin(s), dr * np.sin(s) + r * np.cos(s)
    else:
        raise ValueError(traffic["trajectory"])
    yaw = np.arctan2(dy, dx)
    P = np.zeros((n, 4, 4))
    P[:, 0, 0], P[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    P[:, 1, 0], P[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    P[:, 2, 2] = P[:, 3, 3] = 1.0
    P[:, 0, 3], P[:, 1, 3], P[:, 2, 3] = x, y, h
    return P


def ground_truth(traffic: dict, n: int) -> np.ndarray:
    """Scan-end pose of scans 0..n-1 (scan i sweeps pose i -> i+1)."""
    return trajectory(traffic, n + 1)[1:]


def scan_index(times) -> np.ndarray:
    return np.rint(np.asarray(times, np.float64) / SCAN_PERIOD).astype(int)


# ---- the three steps --------------------------------------------------------

def scan_steps(published: np.ndarray, gt: np.ndarray, first: int,
               skip) -> tuple:
    """Errors (m, deg) of the steps i-1 -> i of the published poses for the
    scans i >= ``first`` (i >= 1), and those i; leaving out the steps
    after a scan in ``skip``: one that ran a mapping tick, whose new
    correction the next pose carries (the keyframe steps judge it), or a
    loop tick, whose closure re-anchors the map by design."""
    idx = np.array([i for i in range(max(first, 1), len(published))
                    if (i - 1) not in skip], int)
    if idx.size == 0:
        return np.zeros(0), np.zeros(0), idx
    est = inv(published[idx - 1]) @ published[idx]
    true = inv(gt[idx - 1]) @ gt[idx]
    return pose_error(est, true) + (idx,)


def keyframe_steps(kf_poses: np.ndarray, kf_scans: np.ndarray,
                   gt: np.ndarray, first: int) -> tuple:
    """Errors of each keyframe's step from the keyframe before, for the
    keyframes of scans >= ``first``, and those scans."""
    k = np.nonzero(kf_scans[1:] >= first)[0] + 1
    if k.size == 0:
        return np.zeros(0), np.zeros(0), k
    est = inv(kf_poses[k - 1]) @ kf_poses[k]
    true = inv(gt[kf_scans[k - 1]]) @ gt[kf_scans[k]]
    return pose_error(est, true) + (kf_scans[k],)


def factor_errors(li, lj, lz, kf_scans, gt) -> tuple:
    """Errors of the accepted loop factors Z = X_i^-1 X_j against the true
    relative pose of their keyframes' scans."""
    if len(li) == 0:
        return np.zeros(0), np.zeros(0)
    true = inv(gt[kf_scans[li]]) @ gt[kf_scans[lj]]
    return pose_error(lz, true)


class GraphSpec:
    """What the configuration states of the pose graph: the prior and
    odometry variances (per twist dimension [w, v]), the loop factors'
    variance and Cauchy scale, the damping added to the information."""

    def __init__(self, pipeline: dict):
        pg, lc = pipeline["posegraph"], pipeline["loop"]
        self.lam_prior = 1.0 / np.asarray(pg["prior_var"]) + pg["damping"]
        self.lam_odom = 1.0 / np.asarray(pg["odom_var"]) + pg["damping"]
        self.w_loop = 1.0 / math.sqrt(lc["loop_noise_var"])
        self.c2 = float(lc["cauchy_k"]) ** 2


def _between(Xi, Xj, Z):
    return se3_log(inv(Z) @ inv(Xi) @ Xj)


def _residuals(X, odom_z, li, lj, lz):
    rp = se3_log(inv(odom_z[0]) @ X[0])
    ro = _between(X[:-1], X[1:], odom_z[1:])
    rl = _between(X[li], X[lj], lz)
    return rp, ro, rl


def graph_cost(spec: GraphSpec, X, odom_z, li, lj, lz) -> float:
    rp, ro, rl = _residuals(X, odom_z, li, lj, lz)
    e2 = ((rl * spec.w_loop) ** 2).sum(-1)
    return float((spec.lam_prior * rp * rp).sum()
                 + (spec.lam_odom * ro * ro).sum()
                 + (spec.c2 * np.log1p(e2 / spec.c2)).sum())


def _jac(fn, Xa, Xb, eps=1e-6):
    """(F,6,12) central-difference Jacobians of fn(Xa, Xb) -> (F,6) under
    left perturbations exp(d) X of each side."""
    F = Xa.shape[0]
    J = np.zeros((F, 6, 12))
    for c in range(12):
        d = np.zeros((F, 6))
        d[:, c % 6] = eps
        E, Em = se3_exp(d), se3_exp(-d)
        if c < 6:
            J[:, :, c] = (fn(E @ Xa, Xb) - fn(Em @ Xa, Xb)) / (2 * eps)
        else:
            J[:, :, c] = (fn(Xa, E @ Xb) - fn(Xa, Em @ Xb)) / (2 * eps)
    return J


def solve_graph(spec: GraphSpec, X0, odom_z, li, lj, lz,
                max_iterations: int = 30, tol: float = 1e-10):
    """Robust (Cauchy, IRLS) Gauss-Newton over the keyframe poses X0 (n,4,4)
    with a prior on node 0 at odom_z[0], between factors odom_z[k] =
    X_{k-1}^-1 X_k, and the loop factors (li, lj, lz); updates
    X <- exp(d) X, the step backtracked on the robust cost.  Returns the
    optimum reached from X0."""
    n = X0.shape[0]
    X = X0.copy()
    cost = graph_cost(spec, X, odom_z, li, lj, lz)
    for _ in range(max_iterations):
        rp, ro, rl = _residuals(X, odom_z, li, lj, lz)
        rows, cols, vals = [], [], []
        g = np.zeros(6 * n)

        def add(nodes, J, r, lam):
            """Blocks of J^T diag(lam) J and J^T diag(lam) r for factors
            on the node pairs ``nodes`` (F,2)."""
            JtL = np.swapaxes(J, -1, -2) * lam[..., None, :]       # (F,12,6)
            H = JtL @ J                                            # (F,12,12)
            b = (JtL @ r[..., None])[..., 0]                       # (F,12)
            for a in range(2):
                np.add.at(g, (6 * nodes[:, a])[:, None] + np.arange(6),
                          b[:, 6 * a:6 * a + 6])
                for c in range(2):
                    ri = (6 * nodes[:, a])[:, None, None] + \
                        np.arange(6)[None, :, None]
                    ci = (6 * nodes[:, c])[:, None, None] + \
                        np.arange(6)[None, None, :]
                    rows.append(np.broadcast_to(ri, (len(nodes), 6, 6))
                                .ravel())
                    cols.append(np.broadcast_to(ci, (len(nodes), 6, 6))
                                .ravel())
                    vals.append(H[:, 6 * a:6 * a + 6, 6 * c:6 * c + 6]
                                .ravel())

        # Prior: a one-node factor, the second node a dummy with no weight.
        Jp = _jac(lambda A, B: se3_log(inv(odom_z[:1]) @ A), X[:1], X[:1])
        Jp[:, :, 6:] = 0.0
        add(np.array([[0, 0]]), Jp, rp[None], spec.lam_prior[None])
        if n > 1:
            Jo = _jac(lambda A, B: _between(A, B, odom_z[1:]), X[:-1], X[1:])
            pairs = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
            add(pairs, Jo, ro, np.broadcast_to(spec.lam_odom, (n - 1, 6)))
        if len(li):
            Jl = _jac(lambda A, B: _between(A, B, lz), X[li], X[lj])
            e2 = ((rl * spec.w_loop) ** 2).sum(-1)
            w = spec.c2 / (spec.c2 + e2) * spec.w_loop ** 2        # IRLS
            add(np.stack([li, lj], 1), Jl, rl,
                np.broadcast_to(w[:, None], (len(li), 6)))
        H = scipy.sparse.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=(6 * n, 6 * n)).tocsc()
        d = -scipy.sparse.linalg.spsolve(H, g).reshape(n, 6)
        if not np.all(np.isfinite(d)):
            break
        for s in (1.0, 0.5, 0.25, 0.1, 0.0):
            Xs = se3_exp(s * d) @ X
            cs = graph_cost(spec, Xs, odom_z, li, lj, lz)
            if cs <= cost + 1e-12 * abs(cost) or s == 0.0:
                break
        step = s * np.abs(d).max()
        X, cost = Xs, cs
        if step <= tol:
            break
    return X


def graph_gap(spec: GraphSpec, kf_poses, odom_z, li, lj, lz) -> tuple:
    """(m, deg): how far the program's loop-corrected keyframe poses lie
    from the optimum of the graph its last closing tick solved (keyframes
    0..max(li), every accepted factor), the re-solve started at the
    program's poses.  (0, 0) without an accepted factor."""
    if len(li) == 0:
        return 0.0, 0.0
    n = int(max(li.max(), lj.max())) + 1
    X = kf_poses[:n]
    Xr = solve_graph(spec, X, odom_z[:n], li, lj, lz)
    dt, dr = pose_error(X, Xr)
    return float(dt.max()), float(dr.max())


def rigidity(T) -> float:
    """The worst departure of (...,4,4) poses from a rigid transform: the
    largest entry of |R^T R - I| and of |bottom row - [0 0 0 1]|.  A true
    pose has none; float32 arithmetic leaves ~1e-6, a product rounded to
    fewer bits leaves its rounding."""
    if not len(T):
        return 0.0
    R = T[..., :3, :3]
    ortho = np.abs(np.swapaxes(R, -1, -2) @ R - np.eye(3)).max()
    bottom = np.abs(T[..., 3, :] - np.array([0.0, 0.0, 0.0, 1.0])).max()
    return float(max(ortho, bottom))


def tf32(x) -> np.ndarray:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_matmul(a, b) -> np.ndarray:
    """a @ b as a TF32 tensor-core product: inputs rounded to TF32, the sum
    kept in float32."""
    return (tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)
            ).astype(np.float32)


def control_poses(gt: np.ndarray) -> np.ndarray:
    """The control: the reference put in the program's place, in the
    nearest precision below the configuration's float32 with TF32 off: a
    perfect odometer that chains the true steps, each pose the TF32
    product of the last and the step (float64 out)."""
    P = [gt[0].astype(np.float32)]
    for i in range(1, len(gt)):
        step = (inv(gt[i - 1]) @ gt[i]).astype(np.float32)
        P.append(tf32_matmul(P[-1], step))
    return np.asarray(P, np.float64)


def control_factors(P: np.ndarray, pairs) -> np.ndarray:
    """Loop factors X_i^-1 X_j of the control's poses, as TF32 products."""
    return np.asarray([tf32_matmul(inv(P[i]), P[j]) for i, j in pairs],
                      np.float64)


# ---- diagnostics (compared with nothing) ------------------------------------

def umeyama(src, dst):
    mu_s, mu_d = src.mean(0), dst.mean(0)
    U, _, Vt = np.linalg.svd((dst - mu_d).T @ (src - mu_s) / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate(est, gt) -> float:
    """RMSE of positions after a rigid Umeyama alignment, m."""
    if len(est) < 3:
        return float("nan")
    p, q = est[:, :3, 3], gt[:, :3, 3]
    R, t = umeyama(p, q)
    return float(np.sqrt((np.linalg.norm(p @ R.T + t - q, axis=1) ** 2)
                         .mean()))


def revisits(gt, radius: float, min_gap_s: float = 20.0):
    """Per scan: within ``radius`` of the path at least ``min_gap_s``
    older; and the event (run of such scans) each scan belongs to, -1
    outside any."""
    pos = gt[:, :3, 3]
    gap = int(round(min_gap_s / SCAN_PERIOD))
    rev = np.zeros(len(pos), bool)
    for i in range(gap + 1, len(pos)):
        d = np.linalg.norm(pos[:i - gap] - pos[i], axis=1)
        rev[i] = bool((d < radius).any())
    start = rev & ~np.concatenate([[False], rev[:-1]])
    return rev, np.where(rev, np.cumsum(start) - 1, -1)


def loop_precision_recall(li, lj, lz, kf_scans, gt, radius,
                          min_gap_s: float = 20.0, settle: int = 0,
                          tol_m=1.0):
    """Precision (true / accepted factors, a factor true within ``tol_m``)
    and recall: the share of revisit events with a true factor at one of
    their scans, counting the events that last ``settle`` scans or more
    among the scans handed in (``gt``'s), so that the loop ticks had time
    to close them."""
    rev, event = revisits(gt, radius, min_gap_s)
    n_events = int(event.max()) + 1
    due = {e for e in range(n_events) if (event == e).sum() >= settle}
    dt, _ = factor_errors(li, lj, lz, kf_scans, gt)
    true = dt < tol_m
    covered = {int(event[kf_scans[i]]) for i, ok in zip(li, true)
               if ok and rev[kf_scans[i]]} & due
    return {"accepted": int(len(li)), "true": int(true.sum()),
            "revisit_events": n_events, "events_due": len(due),
            "precision": float(true.mean()) if len(li) else None,
            "recall": len(covered) / len(due) if due else None}
