"""Trajectory and loop-factor evaluation in numpy: ATE with Umeyama
alignment (port of ``sc_lego_loam_tpu/utils/evaluate.py``, whose alignment
runs in jax) and the precision / recall of accepted loop factors against
ground truth (the measure of the JAX package's ``bench.py``)."""

from __future__ import annotations

import numpy as np

SCAN_PERIOD = 0.1     # seconds between scans of the synthetic drives


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


def revisit_mask(gt: np.ndarray, radius: float, min_gap: float = 20.0):
    """Per-scan bool: true position within ``radius`` of a trajectory
    segment at least ``min_gap`` SECONDS older (a fixed ground-truth
    property, so the recall denominator does not move with the engine).
    Returns (mask (n,), n_events): an event is a run of revisiting scans."""
    pos = np.asarray(gt)[:, :3, 3]
    n = len(pos)
    dt = SCAN_PERIOD
    rev = np.zeros(n, bool)
    for i in range(1, n):
        old = np.arange(i) * dt < i * dt - min_gap
        if old.any():
            d = np.linalg.norm(pos[:i][old] - pos[i], axis=1)
            rev[i] = bool((d < radius).any())
    n_events = int(((~rev[:-1]) & rev[1:]).sum() + int(rev[0]))
    return rev, n_events


def loop_precision_recall(engine, gt: np.ndarray, cfg,
                          tol_m: float = 1.0) -> dict:
    """Hold every ACCEPTED loop factor of ``engine`` against ground truth.

    precision = true factors / accepted factors;
    recall    = revisit events covered by >= 1 true factor / events.
    A factor (i newer, j older, Z = X_i^-1 X_j) is true iff Z's translation
    is within ``tol_m`` of the ground-truth relative translation.  Scans
    are ``SCAN_PERIOD`` apart, which maps a keyframe's time to its scan."""
    loops = engine.loops
    n_acc = min(int(loops.count), loops.i.shape[0])
    li, lj = loops.i.cpu().numpy(), loops.j.cpu().numpy()
    lz = loops.z.cpu().numpy()
    kf_times = engine.m.kf.times.cpu().numpy()
    gt = np.asarray(gt, np.float64)
    dt = SCAN_PERIOD
    rev, n_events = revisit_mask(gt, cfg.loop.rs_search_radius)
    event_id = np.cumsum((~np.concatenate([[False], rev[:-1]])) & rev) - 1
    covered = set()
    tp = 0
    for k in range(n_acc):
        si = min(int(round(float(kf_times[li[k]]) / dt)), len(gt) - 1)
        sj = min(int(round(float(kf_times[lj[k]]) / dt)), len(gt) - 1)
        z_gt = np.linalg.inv(gt[si]) @ gt[sj]
        if np.linalg.norm(lz[k][:3, 3] - z_gt[:3, 3]) < tol_m:
            tp += 1
            if rev[si]:
                covered.add(int(event_id[si]))
    return {
        "revisit_events": n_events,
        "accepted": n_acc,
        "true_factors": tp,
        "precision": tp / n_acc if n_acc else None,
        "recall": len(covered) / n_events if n_events else None,
    }
