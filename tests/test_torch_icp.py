"""ICP verification pieces of the port against the JAX package's: the SVD
rigid fit, the alignment helpers of ``utils/se3`` and ``ops/icp.align``.

The port's 1-NN follows the kernel's contract (squared distances saturate
at 64, an unmatched point reads 64), the JAX package's CPU route
(``ops/knn.nn1``) does not saturate: fitness is therefore compared with the
mean of min(sqd, 64) recomputed in float64 from the JAX transform."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu.ops import icp as jicp
from sc_lego_loam_tpu.utils import se3 as jse3
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch
from sc_lego_loam_tpu_torch.ops import cuda_knn, icp as ticp
from sc_lego_loam_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))


def _rigid(rng, rot, trans):
    w = rng.normal(0, 1, 3)
    w = w / np.linalg.norm(w) * rot
    return np.array(jse3.se3_exp(jnp.asarray(
        np.concatenate([w, rng.normal(0, trans, 3)]), jnp.float32)))


def _rot_deg(a, b):
    R = a[:3, :3].T @ b[:3, :3]
    return np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("seed,weighted", [(0, False), (1, True), (2, True)])
def test_best_fit_transform_matches(seed, weighted):
    """Exact rigid motion of 400 points recovered by both to 1e-4; the two
    fits agree to 2e-5 (fp32 covariance sums, LAPACK SVD on both sides)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (400, 3)).astype(np.float32)
    M = _rigid(rng, 0.4, 2.0)
    dst = (src @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    w = (rng.random(400) < 0.7).astype(np.float32) if weighted else None
    if weighted:
        dst[w == 0] += 50.0          # weight-0 points must not matter
    Tj = np.asarray(jse3.best_fit_transform(
        jnp.asarray(src), jnp.asarray(dst),
        None if w is None else jnp.asarray(w)))
    Tt = tse3.best_fit_transform(T(src), T(dst),
                                 None if w is None else T(w)).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=2e-5)
    np.testing.assert_allclose(Tt, M, atol=1e-4)


def test_best_fit_transform_reflection_case():
    """Coplanar points: the covariance is rank 2 and the determinant fix of
    the Kabsch fit decides the third axis.  A proper rotation from both."""
    rng = np.random.default_rng(3)
    src = rng.uniform(-5, 5, (60, 3)).astype(np.float32)
    src[:, 2] = 0.0
    M = _rigid(rng, 0.3, 1.0)
    dst = (src @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    Tj = np.asarray(jse3.best_fit_transform(jnp.asarray(src),
                                            jnp.asarray(dst)))
    Tt = tse3.best_fit_transform(T(src), T(dst)).numpy()
    assert np.linalg.det(Tt[:3, :3]) == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    np.testing.assert_allclose(Tt, M, atol=1e-4)


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_and_rotation_angle_match(with_scale):
    rng = np.random.default_rng(5)
    src = rng.uniform(-10, 10, (200, 3)).astype(np.float32)
    M = _rigid(rng, 0.8, 3.0)
    scale = 1.7 if with_scale else 1.0
    dst = (scale * src @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    Rj, tj, sj = jse3.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst),
                                        with_scale)
    Rt, tt, st = tse3.umeyama_alignment(T(src), T(dst), with_scale)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=2e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=2e-4)
    assert float(st) == pytest.approx(float(sj), abs=2e-5)
    assert float(st) == pytest.approx(scale, abs=1e-4)
    Rs = np.stack([M[:3, :3], np.eye(3, dtype=np.float32)])
    np.testing.assert_allclose(tse3.rotation_angle(T(Rs)).numpy(),
                               np.asarray(jse3.rotation_angle(jnp.asarray(Rs))),
                               atol=1e-6)
    A = rng.normal(0, 1, (7, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tse3.det3(T(A)).numpy(), np.linalg.det(A),
                               atol=1e-5)


def _yard(rng, n):
    """Points on the ground and the four walls of a 40 x 30 m yard: planes
    in three directions, so the rigid fit is well conditioned."""
    k = n // 5
    u, v, h = (rng.uniform(-1, 1, n) for _ in range(3))
    pts = np.stack([20 * u, 15 * v, np.zeros(n)], 1)             # ground
    for i, (axis, at) in enumerate([(0, 20.0), (0, -20.0), (1, 15.0),
                                    (1, -15.0)]):
        sl = slice((i + 1) * k, (i + 2) * k if i < 3 else n)
        pts[sl, axis] = at
        pts[sl, 2] = 3.0 + 3.0 * h[sl]
    return pts.astype(np.float32)


def _icp_case(seed, far_frac):
    cfg = tiny_test_config()
    rng = np.random.default_rng(seed)
    nq, nt = cfg.cap.icp_query_pad, cfg.cap.history_pad
    dst = _yard(rng, nt) + rng.normal(0, 0.01, (nt, 3)).astype(np.float32)
    dst_mask = rng.random(nt) < 0.8
    M = _rigid(rng, 0.03, 0.15)
    world = _yard(rng, nq)
    Minv = np.linalg.inv(M)
    src = (world @ Minv[:3, :3].T + Minv[:3, 3]).astype(np.float32)
    src_mask = rng.random(nq) < 0.6
    far = rng.random(nq) < far_frac       # points with no target within 8 m
    src[far] += np.array([0.0, 0.0, 40.0], np.float32)
    return cfg, src, src_mask, dst, dst_mask, M


def _saturated_stats(Tm, src, src_mask, dst, dst_mask, inlier_sq):
    """Fitness and inlier ratio of transform ``Tm`` under the kernel's
    contract, brute force in float64."""
    p = src[src_mask].astype(np.float64) @ Tm[:3, :3].T.astype(np.float64) \
        + Tm[:3, 3]
    t = dst[dst_mask].astype(np.float64)
    d = np.full(len(p), np.inf)
    for s in range(0, len(p), 256):
        d[s:s + 256] = ((p[s:s + 256, None] - t[None]) ** 2).sum(-1).min(1)
    d = np.minimum(d, ticp.NN_MAX_SQ_DIST)
    return d.mean(), (d < inlier_sq).mean()


@pytest.mark.parametrize("seed,use_T0", [(0, False), (1, True)])
def test_align_matches(seed, use_T0):
    """Same clouds through both ICPs, every source point with a target
    within range.  T within 1e-3 m / 0.01 deg (15 iterations whose nearest
    neighbours may differ where two targets tie within fp32 rounding of the
    two distance formulas), fitness within 1e-4 and inlier ratio within
    1e-3 of the JAX package's and of the float64 brute force."""
    cfg, src, src_mask, dst, dst_mask, M = _icp_case(seed, 0.0)
    T0 = _rigid(np.random.default_rng(seed + 10), 0.01, 0.05) \
        if use_T0 else None
    launches = dict(cuda_knn.launches)
    Tj, fj, rj = jicp.align(cfg, jnp.asarray(src), jnp.asarray(src_mask),
                            jnp.asarray(dst), jnp.asarray(dst_mask),
                            T0=None if T0 is None else jnp.asarray(T0))
    Tt, ft, rt = ticp.align(tiny_torch(), T(src), T(src_mask), T(dst),
                            T(dst_mask), T0=None if T0 is None else T(T0))
    assert cuda_knn.launches == launches      # CPU tensors: the plain 1-NN
    Tj, Tt = np.asarray(Tj), Tt.numpy()
    assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 1e-3
    assert _rot_deg(Tt, Tj) < 0.01
    # Both moved most of the way to the motion the source was displaced
    # by (1.7 deg, ~0.26 m; 15 point-to-point iterations do not finish).
    assert np.linalg.norm(Tt[:3, 3] - M[:3, 3]) < 0.05
    assert _rot_deg(Tt, M) < 0.3
    fit, ratio = _saturated_stats(Tj, src, src_mask, dst, dst_mask,
                                  cfg.loop.inlier_sq_dist)
    assert float(ft) == pytest.approx(fit, abs=1e-4)
    assert float(rt) == pytest.approx(ratio, abs=1e-3)
    assert float(ft) == pytest.approx(float(fj), abs=1e-4)
    assert float(rt) == pytest.approx(float(rj), abs=1e-3)


@pytest.mark.parametrize("seed,use_T0", [(2, False), (3, True)])
def test_align_saturates_unmatched_points(seed, use_T0):
    """A tenth of the source has no target within 8 m.  The JAX package's
    CPU route matches such a point to a target tens of metres off and adds
    that distance to the fitness; the port follows the kernel: the point
    reads exactly 64 and slot 0.  So the two transforms differ here, and
    the port's fitness and inlier ratio are held to the float64 brute
    force under that contract at the port's own transform."""
    cfg, src, src_mask, dst, dst_mask, _ = _icp_case(seed, 0.1)
    T0 = _rigid(np.random.default_rng(seed + 10), 0.01, 0.05) \
        if use_T0 else None
    Tt, ft, rt = ticp.align(tiny_torch(), T(src), T(src_mask), T(dst),
                            T(dst_mask), T0=None if T0 is None else T(T0))
    fit, ratio = _saturated_stats(Tt.numpy(), src, src_mask, dst, dst_mask,
                                  cfg.loop.inlier_sq_dist)
    assert np.isfinite(Tt.numpy()).all()
    assert float(ft) == pytest.approx(fit, rel=1e-4)
    assert float(rt) == pytest.approx(ratio, abs=1e-3)
    n_far = int((src[src_mask][:, 2] > 30).sum())
    assert n_far > 50
    assert float(ft) >= 64.0 * n_far / src_mask.sum() - 1e-3
    assert float(rt) <= 1.0 - n_far / src_mask.sum() + 1e-6


def test_align_empty_target_is_finite():
    """No valid target: every distance reads 64, fitness 64, ratio 0, T
    stays finite (the JAX CPU route gives inf here)."""
    cfg, src, src_mask, dst, dst_mask, _ = _icp_case(4, 0.0)
    Tt, ft, rt = ticp.align(tiny_torch(), T(src), T(src_mask), T(dst),
                            torch.zeros(len(dst), dtype=torch.bool))
    assert float(ft) == ticp.NN_MAX_SQ_DIST and float(rt) == 0.0
    assert torch.isfinite(Tt).all()
