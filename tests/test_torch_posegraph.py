"""The port's pose graph against the JAX package's: the loop-factor bank
(append, eviction past capacity), the prefix-product scan, the between-
factor Jacobians and ``solve`` on the three fixtures of
tests/test_posegraph.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu import posegraph as jpg
from sc_lego_loam_tpu.config import (LoopClosureConfig, PoseGraphConfig,
                                     tiny_test_config)
from sc_lego_loam_tpu.utils import se3 as jse3
from sc_lego_loam_tpu_torch import posegraph as tpg
from sc_lego_loam_tpu_torch.config import tiny_test_config as tiny_torch
from sc_lego_loam_tpu_torch.utils import convert, se3 as tse3

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))


def _twist(rng, scale):
    return np.array(jse3.se3_exp(jnp.asarray(rng.normal(0, scale, 6),
                                             jnp.float32)))


def _chain(cfg, n, drift=0.0, seed=0):
    """tests/test_posegraph.py's fixture in numpy: a ground-truth square
    loop and drifty odometry.  Returns (gt, poses6 (K,6), odom_z (K,4,4))."""
    rng = np.random.default_rng(seed)
    K = cfg.cap.max_keyframes
    gt = [np.eye(4, dtype=np.float32)]
    side = max(n // 4, 1)
    for i in range(1, n):
        step = np.eye(4, dtype=np.float32)
        step[0, 3] = 1.0
        if i % side == 0:
            step[:2, :2] = [[0.0, -1.0], [1.0, 0.0]]
        gt.append((gt[-1] @ step).astype(np.float32))
    gt = np.stack(gt)
    odom_z = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
    odom_z[0] = gt[0]
    est = [gt[0]]
    for i in range(1, n):
        Z = np.linalg.inv(gt[i - 1]) @ gt[i]
        if drift > 0:
            Z = Z @ _twist(rng, drift)
        odom_z[i] = Z
        est.append((est[-1] @ Z).astype(np.float32))
    poses6 = np.zeros((K, 6), np.float32)
    poses6[:n] = np.asarray(jse3.mat_to_pose6(jnp.asarray(np.stack(est))))
    return gt, poses6, odom_z


def _loops_np(cfg, factors):
    """A JAX loop bank holding ``factors`` [(i, j, Z)], as numpy leaves."""
    loops = jpg.init_loops(cfg)
    for i, j, Z in factors:
        loops = jpg.add_loop(loops, jnp.int32(i), jnp.int32(j),
                             jnp.asarray(Z))
    return jax.tree.map(np.asarray, loops)


def _both_solve(cfg_j, cfg_t, n, poses6, odom_z, loops_np):
    out_j = jpg.solve(cfg_j, jnp.asarray(poses6), jnp.int32(n),
                      jnp.asarray(odom_z),
                      jax.tree.map(jnp.asarray, loops_np))
    out_t = tpg.solve(cfg_t, T(poses6), torch.tensor(n, dtype=torch.int32),
                      T(odom_z),
                      convert.to_torch(tpg.LoopFactors, loops_np, "cpu"))
    Xj = np.asarray(jse3.pose6_to_mat(out_j))
    Xt = tse3.pose6_to_mat(out_t).numpy()
    # Inactive nodes come back untouched.
    np.testing.assert_array_equal(out_t.numpy()[n:], poses6[n:])
    return Xj, Xt


def test_add_loop_below_capacity_matches():
    cj, ct = tiny_test_config(), tiny_torch()
    rng = np.random.default_rng(0)
    lj, lt = jpg.init_loops(cj), tpg.init_loops(ct, "cpu")
    for k in range(5):
        Z = _twist(rng, 0.3)
        lj = jpg.add_loop(lj, jnp.int32(20 + k), jnp.int32(k), jnp.asarray(Z))
        before = lt
        lt = tpg.add_loop(lt, torch.tensor(20 + k), torch.tensor(k), T(Z))
        assert int(before.count) == k          # the old bank is untouched
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert lt.i.dtype == torch.int32 and lt.count.dtype == torch.int32


@pytest.mark.parametrize("with_poses", [False, True])
def test_add_loop_past_capacity_evicts_same_slot(with_poses):
    """A full bank (16 at tiny size): without poses the slot ring-wraps,
    with poses the factor with the largest residual under the current
    estimate goes.  Same slot, same bank, bit for bit, over three
    further appends."""
    cj, ct = tiny_test_config(), tiny_torch()
    L, K = cj.posegraph.max_loops, cj.cap.max_keyframes
    rng = np.random.default_rng(1)
    _, poses6, _ = _chain(cj, 40, drift=0.01, seed=2)
    X = np.asarray(jse3.pose6_to_mat(jnp.asarray(poses6)))
    factors = []
    for k in range(L):
        i, j = 39 - k, k
        Z = np.linalg.inv(X[i]) @ X[j] @ _twist(rng, 0.02 * (1 + (k * 7) % 5))
        factors.append((i, j, Z.astype(np.float32)))
    lnp = _loops_np(cj, factors)
    lj = jax.tree.map(jnp.asarray, lnp)
    lt = convert.to_torch(tpg.LoopFactors, lnp, "cpu")
    pj = jnp.asarray(poses6) if with_poses else None
    pt = T(poses6) if with_poses else None
    for k in range(3):
        Z = _twist(rng, 0.5)
        old = np.asarray(lj.i).copy()
        lj = jpg.add_loop(lj, jnp.int32(30 + k), jnp.int32(3 + k),
                          jnp.asarray(Z), pj)
        lt = tpg.add_loop(lt, torch.tensor(30 + k), torch.tensor(3 + k),
                          T(Z), pt)
        slot_j = int(np.flatnonzero(np.asarray(lj.i) != old)[0])
        assert int(lt.i[slot_j]) == 30 + k
        if not with_poses:
            assert slot_j == k                 # ring wrap
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(lt.count) == L + 3 and K > 40


def test_prefix_products_match_associative_scan():
    """Phi_k = A_k ... A_0 over 64 near-identity 6x6 blocks: the doubling
    scan and ``lax.associative_scan`` multiply in different trees and agree
    to 1e-5; both agree with the sequential product in float64."""
    rng = np.random.default_rng(3)
    A = (np.eye(6) + rng.normal(0, 0.05, (64, 6, 6))).astype(np.float32)
    want = jax.lax.associative_scan(
        lambda a, b: jnp.einsum("...ij,...jk->...ik", b, a), jnp.asarray(A))
    got = tpg.prefix_products(T(A)).numpy()
    seq = [A[0].astype(np.float64)]
    for k in range(1, 64):
        seq.append(A[k].astype(np.float64) @ seq[-1])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got, np.stack(seq), atol=1e-5)
    # A length that is no power of two, and a single block.
    np.testing.assert_allclose(tpg.prefix_products(T(A[:37])).numpy(),
                               np.stack(seq)[:37], atol=1e-5)
    np.testing.assert_array_equal(tpg.prefix_products(T(A[:1])).numpy(),
                                  A[:1])


def test_factor_jacobians_match_and_stay_invertible():
    """6x12 Jacobians of between factors at the zero update, batched in the
    port and vmapped in the JAX package, within 1e-5; the factor between
    two inactive nodes (identity poses, identity measurement) has finite
    tangents and an invertible Jj."""
    rng = np.random.default_rng(4)
    Xi = np.stack([_twist(rng, 0.5) for _ in range(8)] + [np.eye(4)] * 2
                  ).astype(np.float32)
    Xj = np.stack([_twist(rng, 0.5) for _ in range(8)] + [np.eye(4)] * 2
                  ).astype(np.float32)
    Z = np.stack([np.linalg.inv(a) @ b @ _twist(rng, 0.01)
                  for a, b in zip(Xi[:8], Xj[:8])] + [np.eye(4)] * 2
                 ).astype(np.float32)
    zero12 = jnp.zeros((12,), jnp.float32)
    Jj = jax.vmap(jax.jacfwd(jpg._factor_residual),
                  in_axes=(None, 0, 0, 0))(zero12, jnp.asarray(Xi),
                                           jnp.asarray(Xj), jnp.asarray(Z))
    Jt = tpg._factor_jacobian(T(Xi), T(Xj), T(Z)).numpy()
    assert Jt.shape == (10, 6, 12) and Jt.dtype == np.float32
    np.testing.assert_allclose(Jt, np.asarray(Jj), atol=1e-5)
    assert np.isfinite(Jt).all()
    np.testing.assert_allclose(Jt[9][:, 6:], np.eye(6), atol=1e-6)
    np.testing.assert_allclose(Jt[9][:, :6], -np.eye(6), atol=1e-6)


def test_solve_no_loops_is_fixed_point():
    """No loop factors: the odometry chain already satisfies every factor.
    Both leave the poses within 1e-3 (the reference test's bound) and
    agree within 1e-4."""
    cj, ct = tiny_test_config(), tiny_torch()
    _, poses6, odom_z = _chain(cj, 12)
    Xj, Xt = _both_solve(cj, ct, 12, poses6, odom_z, _loops_np(cj, []))
    X0 = np.asarray(jse3.pose6_to_mat(jnp.asarray(poses6)))
    np.testing.assert_allclose(Xt[:12], X0[:12], atol=1e-3)
    np.testing.assert_allclose(Xt[:12], Xj[:12], atol=1e-4)


def test_solve_loop_closes_drift():
    """A drifty square and three exact loop factors between its ends, with
    the relaxed variances of the reference test.  The port passes that
    test's own assertions, and its poses agree with the JAX package's
    within 5e-3 (20 GN iterations with IRLS and a backtracking line search
    over fp32 scans summed in another order)."""
    relax = dict(posegraph=PoseGraphConfig(odom_var=(1e-2,) * 6),
                 loop=LoopClosureConfig(loop_noise_var=1e-2))
    cj = tiny_test_config().replace(**relax)
    from sc_lego_loam_tpu_torch.config import (
        LoopClosureConfig as LoopT, PoseGraphConfig as PoseT)
    ct = tiny_torch().replace(posegraph=PoseT(odom_var=(1e-2,) * 6),
                              loop=LoopT(loop_noise_var=1e-2))
    n = 20
    gt, poses6, odom_z = _chain(cj, n, drift=0.02, seed=1)
    Z = (np.linalg.inv(gt[n - 1]) @ gt[0]).astype(np.float32)
    Xj, Xt = _both_solve(cj, ct, n, poses6, odom_z,
                         _loops_np(cj, [(n - 1, 0, Z)] * 3))
    before = np.asarray(jse3.pose6_to_mat(jnp.asarray(poses6)))[:n]
    after = Xt[:n]

    def loop_res(X):
        return float(np.linalg.norm(np.asarray(jse3.se3_log(jnp.asarray(
            np.linalg.inv(Z) @ np.linalg.inv(X[n - 1]) @ X[0],
            jnp.float32)))))

    assert loop_res(after) < 0.3 * max(loop_res(before), 1e-9) + 1e-3
    np.testing.assert_allclose(after[0], gt[0], atol=1e-2)
    e_before = np.linalg.norm(before[:, :3, 3] - gt[:, :3, 3], axis=1).mean()
    e_after = np.linalg.norm(after[:, :3, 3] - gt[:, :3, 3], axis=1).mean()
    assert e_after < e_before
    np.testing.assert_allclose(Xt[:n], Xj[:n], atol=5e-3)


def test_solve_cauchy_rejects_bad_loop():
    """A wildly wrong factor is downweighted by the Cauchy kernel in both:
    no pose moves by 1 m (the reference test's bound), and the two
    solutions agree within 5e-3."""
    cj, ct = tiny_test_config(), tiny_torch()
    n = 16
    gt, poses6, odom_z = _chain(cj, n)
    bad = np.eye(4, dtype=np.float32)
    bad[:3, 3] = [50.0, -30.0, 10.0]
    Xj, Xt = _both_solve(cj, ct, n, poses6, odom_z,
                         _loops_np(cj, [(n - 1, 0, bad)]))
    err = np.linalg.norm(Xt[:n, :3, 3] - gt[:, :3, 3], axis=1).max()
    assert err < 1.0, f"bad loop dragged poses by {err} m"
    np.testing.assert_allclose(Xt[:n], Xj[:n], atol=5e-3)
