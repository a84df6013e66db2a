"""Trajectory evaluation: ATE with Umeyama alignment, in numpy (port
of ``sc_lego_loam_tpu/utils/evaluate.py``, whose alignment runs in jax)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Least-squares rigid transform aligning src -> dst, both (N,3).
    Returns (R, t) such that dst ~ R @ src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / src.shape[0]
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over positions of (N,4,4) poses,
    after a rigid Umeyama alignment when ``align``."""
    p_est = np.asarray(est, np.float64)[:, :3, 3]
    p_gt = np.asarray(gt, np.float64)[:, :3, 3]
    if align:
        R, t = umeyama_alignment(p_est, p_gt)
        p_est = p_est @ R.T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))

