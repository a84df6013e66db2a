"""Parity of the PyTorch port's math base against the JAX package: SE(3),
the Gauss-Newton solver (Jacobians included), residuals, compaction and
voxel downsampling.  Inputs come from numpy seeds and go through both
functions; every tolerance states its reason."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from sc_lego_loam_tpu import mapping as jmapping, odometry as jodo
from sc_lego_loam_tpu.ops import compact as jcompact, residuals as jres, \
    solver as jsolver, voxel as jvoxel
from sc_lego_loam_tpu.utils import se3 as jse3
from sc_lego_loam_tpu_torch import mapping as tmapping, odometry as todo
from sc_lego_loam_tpu_torch.ops import compact as tcompact, \
    residuals as tres, solver as tsolver, voxel as tvoxel
from sc_lego_loam_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)

# fp32 transcendental functions (sin, cos, atan2, arccos, sqrt) round by
# an ulp or so differently in XLA and in torch: 1e-5 on O(1)-O(10) values.
ATOL = 1e-5


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _twists(seed, n=64):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.4, (n, 3)),
                         rng.normal(0, 2.0, (n, 3))], 1).astype(np.float32)
    xi[0] = 0.0                   # the identity (small-angle branches)
    xi[1, :3] = 1e-6
    return xi


def test_se3_exp_log_inv_transform():
    xi = _twists(0)
    Tj, Tt = jse3.se3_exp(jnp.asarray(xi)), tse3.se3_exp(T(xi))
    np.testing.assert_allclose(N(Tt), N(Tj), atol=ATOL)
    np.testing.assert_allclose(N(tse3.se3_log(Tt)), N(jse3.se3_log(Tj)),
                               atol=1e-4)   # log amplifies by 1/sin
    np.testing.assert_allclose(N(tse3.so3_exp(T(xi[:, :3]))),
                               N(jse3.so3_exp(jnp.asarray(xi[:, :3]))),
                               atol=ATOL)
    np.testing.assert_allclose(N(tse3.mat_inv(Tt)), N(jse3.mat_inv(Tj)),
                               atol=ATOL)
    pts = np.random.default_rng(1).normal(0, 20, (64, 100, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        N(tse3.transform_points(Tt, T(pts))),
        N(jse3.transform_points(Tj, jnp.asarray(pts))), atol=1e-4)


def test_pose6_roundtrip():
    rng = np.random.default_rng(2)
    p6 = np.concatenate([rng.uniform(-0.5, 0.5, (64, 3)),
                         rng.normal(0, 30, (64, 3))], 1).astype(np.float32)
    Mj, Mt = jse3.pose6_to_mat(jnp.asarray(p6)), tse3.pose6_to_mat(T(p6))
    np.testing.assert_allclose(N(Mt), N(Mj), atol=ATOL)
    np.testing.assert_allclose(N(tse3.mat_to_pose6(Mt)),
                               N(jse3.mat_to_pose6(Mj)), atol=1e-4)


def test_solve3_and_solve_spd():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(128, 3, 3)).astype(np.float32) + 3 * np.eye(3,
                                                                 dtype=np.float32)
    b = rng.normal(size=(128, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tsolver.solve3(T(A), T(b))),
                               N(jsolver.solve3(jnp.asarray(A),
                                                jnp.asarray(b))),
                               rtol=1e-4, atol=1e-5)
    M = rng.normal(size=(6, 6)).astype(np.float32)
    spd = (M @ M.T + 0.5 * np.eye(6)).astype(np.float32)
    g = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(N(tsolver.solve_spd(T(spd), T(g))),
                               N(jsolver.solve_spd(jnp.asarray(spd),
                                                   jnp.asarray(g))),
                               rtol=1e-4, atol=1e-5)
    # A non-positive pivot gives NaN in both (the callers' isfinite guard).
    bad = spd.copy()
    bad[2, 2] = -1.0
    assert np.isnan(N(tsolver.solve_spd(T(bad), T(g)))).any()
    assert np.isnan(N(jsolver.solve_spd(jnp.asarray(bad),
                                        jnp.asarray(g)))).any()


def test_sym3_eig():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(256, 5, 3)).astype(np.float32)
    X[:, :, 0] *= 4.0                          # a dominant direction
    cov = np.einsum("qki,qkj->qij", X, X).astype(np.float32) / 5
    cov[0] = np.eye(3) * 2.0                   # isotropic branch
    ej, vj = jsolver.sym3_eig(jnp.asarray(cov))
    et, vt = tsolver.sym3_eig(T(cov))
    # Closed-form trig eigenvalues: relative fp32 rounding of ~1e-5.
    np.testing.assert_allclose(N(et), N(ej), rtol=1e-4, atol=1e-4)
    dots = np.abs((N(vt) * N(vj)).sum(-1))     # unit vectors, up to sign
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


def test_gauss_newton_degeneracy_robust_converged():
    rng = np.random.default_rng(5)
    J = rng.normal(size=(500, 6)).astype(np.float32)
    J[:, 5] *= 0.01                            # one weak direction
    r = rng.normal(size=500).astype(np.float32)
    w = rng.uniform(0, 1, 500).astype(np.float32)
    outj = jsolver.gauss_newton_step(jnp.asarray(J), jnp.asarray(r),
                                     jnp.asarray(w))
    outt = tsolver.gauss_newton_step(T(J), T(r), T(w))
    for a, b in zip(outt, outj):
        # Sums of 500 products in another order: relative 1e-4.
        np.testing.assert_allclose(N(a), N(b), rtol=1e-3, atol=1e-3)
    H = N(outj[1])
    Pj, dj = jsolver.degeneracy_projector(jnp.asarray(H), 1.0)
    Pt, dt = tsolver.degeneracy_projector(T(H), 1.0)
    assert bool(dj) and bool(dt)
    np.testing.assert_allclose(N(Pt), N(Pj), atol=1e-4)
    res = np.abs(r)
    for on in (True, False):
        np.testing.assert_allclose(
            N(tsolver.robust_weight(T(res), 1.8, 0.1, on)),
            N(jsolver.robust_weight(jnp.asarray(res), 1.8, 0.1, on)),
            atol=1e-6)
    for d in ([1e-4, 0, 0, 1e-4, 0, 0], [0.01, 0, 0, 0, 0, 0],
              [0, 0, 0, 0, 0, 0.01]):
        d = np.asarray(d, np.float32)
        assert bool(tsolver.converged(T(d[:3]), T(d[3:]), 0.1, 0.1)) == \
            bool(jsolver.converged(jnp.asarray(d[:3]), jnp.asarray(d[3:]),
                                   0.1, 0.1))


def test_residuals():
    rng = np.random.default_rng(6)
    p, a, b, c = (rng.normal(0, 10, (300, 3)).astype(np.float32)
                  for _ in range(4))
    np.testing.assert_allclose(
        N(tres.point_to_line(T(p), T(a), T(b))),
        N(jres.point_to_line(*map(jnp.asarray, (p, a, b)))),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        N(tres.point_to_plane(T(p), T(a), T(b), T(c))),
        N(jres.point_to_plane(*map(jnp.asarray, (p, a, b, c)))),
        rtol=1e-4, atol=1e-4)
    d = rng.normal(size=300).astype(np.float32)
    np.testing.assert_allclose(
        N(tres.point_to_plane_nd(T(p), T(a), T(d))),
        N(jres.point_to_plane_nd(*map(jnp.asarray, (p, a, d)))), atol=1e-4)


@pytest.mark.parametrize("xi_scale", [0.0, 0.05])
def test_residual_jacobians_match_jax(xi_scale):
    """Forward-mode Jacobians of the odometry and scan-to-map residuals
    (torch.func.jacfwd) against jax.jacfwd, at the identity and away."""
    rng = np.random.default_rng(7)
    xi = (rng.normal(size=6) * xi_scale).astype(np.float32)
    q, a, b, c = (rng.normal(0, 10, (200, 3)).astype(np.float32)
                  for _ in range(4))
    Jj = jax.jacfwd(lambda x: jodo._corner_residual(
        x, jnp.asarray(q), jnp.asarray(a), jnp.asarray(b)))(jnp.asarray(xi))
    Jt = jacfwd(lambda x: todo._corner_residual(x, T(q), T(a), T(b)))(T(xi))
    # Jacobian entries scale with the 10 m lever arm: relative 1e-4.
    np.testing.assert_allclose(N(Jt), N(Jj), rtol=1e-4, atol=1e-3)
    Jj = jax.jacfwd(lambda x: jodo._surf_residual(
        x, *map(jnp.asarray, (q, a, b, c))))(jnp.asarray(xi))
    Jt = jacfwd(lambda x: todo._surf_residual(x, T(q), T(a), T(b),
                                              T(c)))(T(xi))
    np.testing.assert_allclose(N(Jt), N(Jj), rtol=1e-4, atol=1e-3)

    # Scan-to-map: residuals of points moved by exp(delta) @ T0.
    T0 = np.asarray(jse3.se3_exp(jnp.asarray(_twists(8)[5])))
    nu = rng.normal(size=(200, 3)).astype(np.float32)
    nu /= np.linalg.norm(nu, axis=1, keepdims=True)
    dof = rng.normal(size=200).astype(np.float32)

    def rj(d):
        Td = jse3.se3_exp(d) @ jnp.asarray(T0)
        pc = jmapping._transform(Td, jnp.asarray(q))
        return jnp.concatenate([
            jres.point_to_line(pc, jnp.asarray(a), jnp.asarray(b)),
            jnp.sum(pc * jnp.asarray(nu), -1) + jnp.asarray(dof)])

    def rt(d):
        Td = tse3.se3_exp(d) @ T(T0)
        pc = tmapping._transform(Td, T(q))
        return torch.cat([tres.point_to_line(pc, T(a), T(b)),
                          (pc * T(nu)).sum(-1) + T(dof)])

    np.testing.assert_allclose(N(jacfwd(rt)(T(xi))),
                               N(jax.jacfwd(rj)(jnp.asarray(xi))),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("pad", [16, 300, 1000])
def test_compact_exact(pad):
    rng = np.random.default_rng(9)
    mask = rng.random(1000) > 0.7
    vals = rng.normal(size=(1000, 3)).astype(np.float32)
    ij, okj = jcompact.compact_indices(jnp.asarray(mask), pad)
    it, okt = tcompact.compact_indices(T(mask), pad)
    np.testing.assert_array_equal(N(it), N(ij))
    np.testing.assert_array_equal(N(okt), N(okj))
    oj, _ = jcompact.compact(jnp.asarray(vals), jnp.asarray(mask), pad)
    ot, _ = tcompact.compact(T(vals), T(mask), pad)
    np.testing.assert_array_equal(N(ot), N(oj))


def _voxel_cloud(seed):
    """Street-scale cloud plus far points whose voxel coordinates overflow
    int32 when the hash multiplies them by its primes (wraparound)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-60, 60, (6000, 3)).astype(np.float32)
    pts[:500] = rng.uniform(-3000, 3000, (500, 3))
    mask = rng.random(6000) > 0.2
    return pts, mask


def test_voxel_hash_and_decimate_match_jax():
    pts, mask = _voxel_cloud(10)
    oj, okj, _ = jvoxel.voxel_downsample_hash(
        jnp.asarray(pts), jnp.asarray(mask), 0.4, 4096, table_bits=14)
    ot, okt = tvoxel.voxel_downsample_hash(T(pts), T(mask), 0.4, 4096,
                                              table_bits=14)
    np.testing.assert_array_equal(N(okt), N(okj))      # same buckets
    # Centroids: float sums in another order, relative 1e-6 of 3000 m.
    np.testing.assert_allclose(N(ot), N(oj), rtol=1e-5, atol=1e-3)
    for bits in (14, 18):
        dj = jvoxel.voxel_decimate(jnp.asarray(pts), jnp.asarray(mask), 0.3,
                                   4096, table_bits=bits, return_indices=True)
        dt = tvoxel.voxel_decimate(T(pts), T(mask), 0.3, 4096,
                                   table_bits=bits, return_indices=True)
        for a, b in zip(dt, dj):
            np.testing.assert_array_equal(N(a), N(b))   # integer scatter-min
