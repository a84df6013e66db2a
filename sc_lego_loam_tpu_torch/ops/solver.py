"""Gauss-Newton machinery shared by scan-to-scan and scan-to-map LM
(port of ``sc_lego_loam_tpu/ops/solver.py``)."""

from __future__ import annotations

import math

import torch

from .symeig import symeig


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) batched 3x3 solve."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = 1.0 / torch.where(det.abs() < 1e-12,
                                torch.full_like(det, 1e-12), det)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
    x1 = (c10 * b0 + c11 * b1 + c12 * b2) * inv_det
    x2 = (c20 * b0 + c21 * b1 + c22 * b2) * inv_det
    return torch.stack([x0, x1, x2], -1)


def robust_weight(abs_res: torch.Tensor, slope: float, min_weight: float,
                  enabled) -> torch.Tensor:
    """LOAM's linear robust weight s = 1 - slope*|d|; s <= min_weight is
    dropped.  ``enabled`` (python bool) gates it."""
    if not enabled:
        return torch.ones_like(abs_res)
    s = 1.0 - slope * abs_res
    return torch.where(s > min_weight, s, torch.zeros_like(s))


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled-Cholesky solve of a small SPD system.  A non-positive pivot
    gives NaN, which the callers' isfinite guards turn into a zero step."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.where(
                    s > 0, s, torch.full_like(s, math.nan)))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)


def gauss_newton_step(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                      damping: float = 1e-6):
    """One damped GN step. J: (N,P), r: (N,), w: (N,) weights.
    Returns (delta (P,), H (P,P), g (P,)) minimizing sum w (J d + r)^2."""
    Jw = J * w[:, None]
    H = Jw.T @ J
    g = Jw.T @ r
    P = J.shape[1]
    eye = torch.eye(P, dtype=J.dtype, device=J.device)
    return solve_spd(H + damping * eye, -g), H, g


def sym3_eig(A: torch.Tensor):
    """Closed-form eigendecomposition of batched symmetric 3x3 matrices.
    Returns (evals (...,3) ascending, unit eigenvector (...,3) of the
    largest eigenvalue)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    iso = p2 < 1e-20
    ps = torch.where(iso, torch.ones_like(p), p)
    b00, b11, b22 = d0 / ps, d1 / ps, d2 / ps
    b01, b02, b12 = a01 / ps, a02 / ps, a12 / ps
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_max = q + 2.0 * p * torch.cos(phi)
    e_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_max - e_min
    e_max = torch.where(iso, q, e_max)
    e_mid = torch.where(iso, q, e_mid)
    e_min = torch.where(iso, q, e_min)
    evals = torch.stack([e_min, e_mid, e_max], -1)

    # Eigenvector of e_max: the largest-norm column of
    # (A - e_mid I)(A - e_min I) (Cayley-Hamilton).
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    C = (A - e_mid[..., None, None] * eye) @ (A - e_min[..., None, None] * eye)
    norms = torch.linalg.vector_norm(C, dim=-2)
    best = torch.argmax(norms, -1)
    v = torch.gather(C, -1, best[..., None, None].expand(
        C.shape[:-1] + (1,)))[..., 0]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = eye[2].expand(v.shape)
    v = torch.where(vn > 1e-12, v / torch.clamp(vn, min=1e-12), fallback)
    return evals, v


def degeneracy_projector(H: torch.Tensor, eig_threshold: float):
    """Null-space projection matrix matP (fA.cpp:1329-1356): zero the
    update along eigenvectors of H with small eigenvalues.  Returns
    (P_mat, is_degenerate).  The eigendecomposition is ``ops/symeig``: on
    the card a kernel that reads nothing back on the host (the JAX
    package's ``jnp.linalg.eigh``)."""
    evals, evecs = symeig(H)                       # ascending
    ok = (evals > eig_threshold).to(H.dtype)
    Pm = (evecs * ok[None, :]) @ evecs.T
    return Pm, (ok < 0.5).any()


def converged(delta_w: torch.Tensor, delta_v: torch.Tensor,
              rot_deg: float, trans_cm: float):
    """LOAM convergence test: rotation update below ``rot_deg`` degrees and
    translation update below ``trans_cm`` cm."""
    dr = torch.rad2deg(torch.linalg.vector_norm(delta_w))
    dt = torch.linalg.vector_norm(delta_v) * 100.0
    return (dr < rot_deg) & (dt < trans_cm)


def freeze(done, old, new):
    """Per-leaf ``where(done, old, new)`` over matching tuples: the fixed-
    count LM loops keep a converged state without reading ``done`` on the
    host (the JAX package gates its unrolled iterations with ``lax.cond``)."""
    return tuple(freeze(done, o, n) if isinstance(o, tuple)
                 else torch.where(done, o, n) for o, n in zip(old, new))
