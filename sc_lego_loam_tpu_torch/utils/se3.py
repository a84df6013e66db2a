"""SO(3)/SE(3) utilities (port of ``sc_lego_loam_tpu/utils/se3.py``).

Poses are 4x4 homogeneous matrices, increments se(3) twists [w, v].  All
functions are batch-friendly (leading dims broadcast) and keep the JAX
package's double-``where`` guards, so ``torch.func.jacfwd`` through them is
finite at the identity.
"""

from __future__ import annotations

import torch

from ..ops.symeig import symeig

_EPS = 1e-9


def hat(w):
    """so(3) hat operator: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(w):
    """Rodrigues: (...,3) -> (...,3,3)."""
    t2 = (w * w).sum(-1)[..., None, None]
    small = t2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    W = hat(w)
    W2 = W @ W
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta))
                    / torch.where(small, torch.ones_like(t2), t2))
    return _eye3(w) + a * W + b * W2


def so3_log(R):
    """(...,3,3) -> (...,3). Principal log of a rotation matrix."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    small = cos > 1.0 - 1e-5
    cos_safe = torch.where(small, torch.zeros_like(cos), cos)
    theta = torch.where(small, torch.zeros_like(cos), torch.arccos(cos_safe))
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    s = torch.sin(theta)
    t2_small = 2.0 * (1.0 - cos)
    sm = small[..., None]
    coef = torch.where(sm, 0.5 + t2_small[..., None] / 12.0,
                       theta[..., None] / torch.where(
                           sm, torch.ones_like(s[..., None]),
                           2.0 * s[..., None] + _EPS))
    w_reg = coef * w
    # Near theta = pi: axis from the diagonal, sign from the off-diagonal.
    near_pi = theta > 3.0
    d = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis = torch.sqrt(torch.clamp(
        (d - cos[..., None]) / torch.clamp(1.0 - cos[..., None], min=_EPS),
        0.0, 1.0))
    sign = torch.sign(w + 1e-12)
    w_pi = axis * sign * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_reg)


def se3_exp(xi):
    """(...,6) twist [w, v] -> (...,4,4)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t2 = (w * w).sum(-1)[..., None, None]
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2s)
    W = hat(w)
    W2 = W @ W
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta)) / (t2s * theta))
    V = _eye3(xi) + b * W + c * W2
    t = (V @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T):
    """(...,4,4) -> (...,6) twist [w, v]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    t2 = (w * w).sum(-1)[..., None, None]
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2s)
    W = hat(w)
    W2 = W @ W
    s, cth = torch.sin(theta), torch.cos(theta)
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                       (1.0 / t2s) - (1.0 + cth) / (2.0 * theta * s + _EPS))
    Vinv = _eye3(T) - 0.5 * W + coef * W2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], -1)


def rt_to_mat(R, t):
    """(...,3,3),(...,3) -> (...,4,4)."""
    top = torch.cat([R, t[..., None]], -1)                     # (...,3,4)
    # [0 0 0 1] from fills: writing a Python scalar into a CUDA slice is
    # a host->device copy that synchronizes.
    batch = R.shape[:-2]
    kw = dict(dtype=R.dtype, device=R.device)
    bottom = torch.cat([torch.zeros(batch + (1, 3), **kw),
                        torch.ones(batch + (1, 1), **kw)], -1)
    return torch.cat([top, bottom], -2)


def mat_inv(T):
    """Inverse of an SE(3) matrix (no general 4x4 inversion)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T, pts):
    """Apply (...,4,4) to (...,N,3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def euler_zyx_to_mat(yaw, pitch, roll):
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr,
                        cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr,
                        sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], -2)


def mat_to_euler_zyx(R):
    """Inverse of euler_zyx_to_mat: returns (yaw, pitch, roll)."""
    pitch = -torch.arcsin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return yaw, pitch, roll


def pose6_to_mat(p):
    """6-vec (roll, pitch, yaw, x, y, z) -> 4x4."""
    R = euler_zyx_to_mat(p[..., 2], p[..., 1], p[..., 0])
    return rt_to_mat(R, p[..., 3:6])


def mat_to_pose6(T):
    yaw, pitch, roll = mat_to_euler_zyx(T[..., :3, :3])
    return torch.cat([torch.stack([roll, pitch, yaw], -1), T[..., :3, 3]], -1)


def det3(A):
    """Closed-form determinant of (...,3,3) (``torch.linalg.det`` checks its
    LU's status on the host, which synchronizes a CUDA stream)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def _kabsch_rotation(cov):
    """Rotation R maximizing tr(R^T cov): U diag(1,1,det(U Vt)) Vt.
    Returns (R, singular values, sign (3,)).  ``torch.linalg.svd`` reads
    its status on the host: on a CUDA tensor each call synchronizes."""
    U, D, Vt = torch.linalg.svd(cov)
    det = det3(U) * det3(Vt)
    one = torch.ones((), dtype=cov.dtype, device=cov.device)
    sign = torch.stack([one, one, torch.where(det < 0, -one, one)])
    return (U * sign[None, :]) @ Vt, D, sign


def umeyama_alignment(src, dst, with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst, both (N,3).
    Returns (R, t, s) such that dst ~ s * R @ src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    R, D, sign = _kabsch_rotation(xd.T @ xs / src.shape[0])
    var_s = (xs ** 2).sum() / src.shape[0]
    s = (D * sign).sum() / torch.clamp(var_s, min=_EPS) if with_scale \
        else torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * R @ mu_s
    return R, t, s


def quat_to_mat(q):
    """Unit quaternion (w, x, y, z) (..., 4) -> rotation (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def best_fit_transform(src, dst, weights=None):
    """Weighted point-to-point rigid fit: finds T with dst ~ R src + t (the
    estimator inside ICP verification, mapOptmization.cpp:1012/1060).
    src, dst: (N,3); weights: (N,) or None.

    Horn's quaternion method (J. Opt. Soc. Am. A 4, 629, 1987): with the
    weighted cross-covariance S = sum w xs xd^T of the centred points, the
    rotation is the unit quaternion of the largest eigenvalue of the 4x4
    symmetric [[tr S, d^T], [d, S + S^T - tr(S) I]], d = (S_yz - S_zy,
    S_zx - S_xz, S_xy - S_yx).  It is always a proper rotation, the one
    the JAX package's SVD fit gives after its reflection fix (Kabsch with
    det(U Vt) < 0 flipping the last axis, ``_kabsch_rotation``).  The
    eigenvector comes from ``ops/symeig``: on the card a kernel that reads
    nothing back, where ``torch.linalg.svd`` synchronizes every call."""
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(weights.sum(), min=_EPS)
    mu_s = (weights[:, None] * src).sum(0) / wsum
    mu_d = (weights[:, None] * dst).sum(0) / wsum
    xs = src - mu_s
    xd = dst - mu_d
    S = (weights[:, None] * xs).T @ xd
    tr = S[0, 0] + S[1, 1] + S[2, 2]
    A = S - S.T
    d = torch.stack([A[1, 2], A[2, 0], A[0, 1]])
    lower = S + S.T - tr * _eye3(S)
    N = torch.cat([torch.cat([tr.reshape(1, 1), d[None]], 1),
                   torch.cat([d[:, None], lower], 1)], 0)
    _, V = symeig(N)
    R = quat_to_mat(V[:, 3])
    return rt_to_mat(R, mu_d - R @ mu_s)


def rotation_angle(R):
    """Geodesic angle of a rotation matrix (radians)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
