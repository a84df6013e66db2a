"""The plain reference's SE(3) helpers and pose-graph re-solve against the
port's (``utils/se3``, ``posegraph.solve``) on a hand-made graph."""

import dataclasses

import numpy as np
import torch

from sc_lego_loam_tpu_torch import posegraph
from sc_lego_loam_tpu_torch.config import default_config
from sc_lego_loam_tpu_torch.utils import se3
from slambench import reference as ref


def test_se3_matches_port():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, [0.5] * 3 + [5.0] * 3, (64, 6))
    xi[:4, :3] *= 1e-7                      # near-zero rotations
    T = ref.se3_exp(xi)
    Tt = se3.se3_exp(torch.tensor(xi)).numpy()
    np.testing.assert_allclose(T, Tt, atol=1e-9)
    np.testing.assert_allclose(ref.se3_log(T), xi, atol=1e-9)
    np.testing.assert_allclose(ref.se3_log(T),
                               se3.se3_log(torch.tensor(T)).numpy(),
                               atol=1e-6)
    p6 = rng.normal(0, [0.3, 0.3, 2.0, 10, 10, 1], (16, 6))
    np.testing.assert_allclose(ref.pose6_to_mat(p6),
                               se3.pose6_to_mat(torch.tensor(p6)).numpy(),
                               atol=1e-12)


def _graph(n=40, seed=0):
    """A drifting ring of n keyframes closed by two loop factors."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi * 0.95, n)
    T = np.zeros((n, 4, 4))
    T[:, 3, 3] = 1
    c, s = np.cos(th + np.pi / 2), np.sin(th + np.pi / 2)
    T[:, 0, 0], T[:, 0, 1], T[:, 1, 0], T[:, 1, 1] = c, -s, s, c
    T[:, 2, 2] = 1
    T[:, 0, 3], T[:, 1, 3] = 10 * np.cos(th), 10 * np.sin(th)
    odom = np.tile(np.eye(4), (n, 1, 1))
    odom[0] = T[0]
    for k in range(1, n):
        odom[k] = ref.inv(T[k - 1]) @ T[k] @ ref.se3_exp(
            rng.normal(0, [0.002] * 3 + [0.02] * 3))
    X = odom.copy()
    for k in range(1, n):
        X[k] = X[k - 1] @ odom[k]
    li, lj = np.array([n - 1, n - 2]), np.array([0, 1])
    return X, odom, li, lj, ref.inv(T[li]) @ T[lj]


def test_graph_resolve_against_port():
    cfg = default_config()
    cfg = cfg.replace(posegraph=dataclasses.replace(cfg.posegraph,
                                                    max_loops=8))
    spec = ref.GraphSpec(dataclasses.asdict(cfg))
    X, odom, li, lj, lz = _graph()
    n, L = len(X), 8
    f32 = torch.float32
    loops = posegraph.LoopFactors(
        i=torch.tensor(np.r_[li, np.zeros(L - 2)], dtype=torch.int32),
        j=torch.tensor(np.r_[lj, np.zeros(L - 2)], dtype=torch.int32),
        z=torch.tensor(np.concatenate([lz, np.tile(np.eye(4), (L - 2, 1, 1))]),
                       dtype=f32),
        count=torch.tensor(2, dtype=torch.int32))
    out = posegraph.solve(cfg, se3.mat_to_pose6(torch.tensor(X, dtype=f32)),
                          torch.tensor(n, dtype=torch.int32),
                          torch.tensor(odom, dtype=f32), loops)
    Xp = ref.pose6_to_mat(out.double().numpy())
    Xr = ref.solve_graph(spec, X, odom, li, lj, lz)
    # The reference reaches a lower robust cost than both the start and
    # the port's float32 solve, and the two agree to millimetres.
    c0, cp, cr = (ref.graph_cost(spec, Y, odom, li, lj, lz)
                  for Y in (X, Xp, Xr))
    assert cr <= cp < c0
    gap_m, gap_deg = ref.graph_gap(spec, Xp, odom, li, lj, lz)
    assert gap_m < 0.01 and gap_deg < 0.05
    # Started from the port's answer or from the odometry chain, the same
    # optimum.
    Xr2 = ref.solve_graph(spec, Xp, odom, li, lj, lz)
    assert ref.pose_error(Xr, Xr2)[0].max() < 1e-6
    # Poses rounded to bfloat16 lie far from it.
    Xh = torch.tensor(Xp).to(torch.bfloat16).double().numpy()
    assert ref.graph_gap(spec, Xh, odom, li, lj, lz)[0] > 3 * gap_m


def test_errors_are_frame_free():
    X, _, _, _, _ = _graph(12)
    A = ref.se3_exp(np.array([0.1, -0.2, 0.3, 4.0, 5.0, -1.0]))
    gt = X.copy()
    est = A @ X
    dt, dr, _ = ref.scan_steps(est, gt, 1, set())
    assert dt.max() < 1e-12 and dr.max() < 1e-9
    est[5, 0, 3] += 1.0
    dt, _, at = ref.scan_steps(est, gt, 1, set())
    assert abs(dt.max() - 1.0) < 0.2 and at[dt.argmax()] in (5, 6)
    dt, _, _ = ref.scan_steps(est, gt, 1, {4, 5})
    assert dt.max() < 1e-9
