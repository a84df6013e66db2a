"""Parity of the port's feature extraction, correspondence search, de-skew
and one scan-to-scan odometry step against the JAX package, from the same
features and the same odometry state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu import frontend as jfront, odometry as jodo
from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu.ops import features as jfeat
from sc_lego_loam_tpu.utils import synthetic
from sc_lego_loam_tpu_torch import odometry as todo
from sc_lego_loam_tpu_torch.ops import compaction as tcompaction, \
    features as tfeat
from sc_lego_loam_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def seq():
    """Three scans of a turning straight drive; the JAX front end's
    segmented clouds, brought across as they are."""
    cfg = tiny_test_config()
    scans, valids, _ = synthetic.make_sequence(
        cfg.lidar, 3, trajectory="straight", step=0.3, yaw_rate=0.02,
        noise=0.005, seed=5)
    clouds = [jfront.run(cfg, jnp.asarray(s), jnp.asarray(v)).cloud
              for s, v in zip(scans, valids)]
    return cfg, clouds


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


_jextract = jax.jit(jfeat.extract, static_argnums=(1, 2, 3))


@pytest.mark.parametrize("sparse", [False, True])
def test_extract_matches_jax(seq, sparse):
    """Dense (the engine's path) and sparse pick sets: same features,
    exactly — every pick is an integer decision on the same curvatures."""
    cfg, clouds = seq
    for cloud in clouds:
        fj = _jextract(cloud, cfg.feat, cfg.cap, sparse)
        ft = tfeat.extract(to_torch(tcompaction.SegmentedCloud,
                                    _np_tree(cloud), "cpu"),
                           cfg.feat, cfg.cap, sparse_picks=sparse)
        for name in ft._fields:
            a, b = getattr(ft, name), getattr(fj, name)
            np.testing.assert_array_equal(N(a.mask), N(b.mask), name)
            np.testing.assert_array_equal(N(a.ring), N(b.ring), name)
            np.testing.assert_array_equal(N(a.xyz), N(b.xyz), name)
            np.testing.assert_array_equal(N(a.rel_time), N(b.rel_time), name)
        assert int(ft.less_flat.mask.sum()) > 100
        if sparse:
            assert int(ft.flat.mask.sum()) > 0


def _features(cfg, cloud):
    fj = _jextract(cloud, cfg.feat, cfg.cap, False)
    return fj, to_torch(tfeat.FeatureSet, _np_tree(fj), "cpu")


def test_correspondence_search_matches_jax(seq):
    """Packed-key nearest / ring-window searches: the (Q,T) distance
    matrix is a matmul summed in another order, which can move a key
    across a quantization step only at exact-distance ties."""
    cfg, clouds = seq
    f0j, f0t = _features(cfg, clouds[0])
    f1j, f1t = _features(cfg, clouds[1])
    oc = cfg.odom
    cj = jodo._find_corner(f1j.less_sharp.xyz, f1j.less_sharp.mask,
                           f0j.less_sharp, oc)
    ct = todo._find_corner(f1t.less_sharp.xyz, f1t.less_sharp.mask,
                           f0t.less_sharp, oc)
    sj = jodo._find_surf(f1j.less_flat.xyz, f1j.less_flat.mask,
                         f0j.less_flat, oc)
    st = todo._find_surf(f1t.less_flat.xyz, f1t.less_flat.mask,
                         f0t.less_flat, oc)
    for got, ref in ((ct, cj), (st, sj)):
        valid = N(ref[-1])
        np.testing.assert_array_equal(N(got[-1]), valid)
        assert valid.sum() > 10
        for a, b in zip(got[:-1], ref[:-1]):
            agree = (N(a) == N(b))[valid].mean()
            assert agree > 0.99, agree


def test_deskew_with_twist_matches_jax():
    rng = np.random.default_rng(8)
    xi = np.array([0.01, -0.02, 0.05, 0.8, 0.1, -0.02], np.float32)
    pts = rng.normal(0, 20, (2000, 3)).astype(np.float32)
    s = rng.uniform(0, 1, 2000).astype(np.float32)
    np.testing.assert_allclose(
        N(todo.deskew_with_twist(T(xi), T(pts), T(s))),
        N(jodo.deskew_with_twist(jnp.asarray(xi), jnp.asarray(pts),
                                 jnp.asarray(s))), atol=1e-4)


def test_one_odometry_step_matches_jax(seq):
    """Both packages initialize on scan 0, then the port steps scan 1 from
    the JAX state brought across.  The LM runs on sums of ~2k products
    taken in another order; the pose agrees far below the odometry's own
    error on this fixture (tests/test_odometry.py: 0.1 m, 0.012 rad)."""
    cfg, clouds = seq
    f0j, _ = _features(cfg, clouds[0])
    f1j, f1t = _features(cfg, clouds[1])
    s0 = jodo.init_state(cfg)
    s1, _, _ = jodo.step(cfg, s0, f0j)
    st = to_torch(todo.OdometryState, _np_tree(s1), "cpu")
    s2j, pose_j, xi_j = jodo.step(cfg, s1, f1j)
    s2t, pose_t, xi_t = todo.step(cfg, st, f1t)
    assert np.linalg.norm(N(xi_j)[3:]) > 0.2          # it really moved
    np.testing.assert_allclose(N(xi_t), N(xi_j), atol=2e-4)
    np.testing.assert_allclose(N(pose_t), N(pose_j), atol=2e-4)
    assert bool(s2t.initialized)
    assert torch.equal(s2t.corner_last.xyz, f1t.less_sharp.xyz)


def test_first_step_initializes_without_motion(seq):
    cfg, clouds = seq
    _, f0t = _features(cfg, clouds[0])
    st, pose, xi = todo.step(cfg, todo.init_state(cfg, "cpu"), f0t)
    assert torch.equal(pose, torch.eye(4)) and not xi.any()
    assert bool(st.initialized)
