"""Parity of the port's front end (projection, ground, segmentation,
compaction, ``frontend.run``) against the JAX package on the scene of
tests/test_frontend.py, plus the BFS parity of the port's segmentation and
a check of its segmented min-scan."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu import frontend as jfront
from sc_lego_loam_tpu.config import tiny_test_config
from sc_lego_loam_tpu.ops import projection as jproj
from sc_lego_loam_tpu.utils import synthetic
from sc_lego_loam_tpu_torch import frontend as tfront
from sc_lego_loam_tpu_torch.ops import compaction as tcompaction, \
    ground as tground, projection as tproj, segmentation as tseg

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def scene():
    cfg = tiny_test_config()
    world = synthetic.default_world(seed=3)
    pose = np.eye(4)
    pose[2, 3] = 2.0
    pts, valid = synthetic.raycast(world, pose, cfg.lidar, noise=0.01,
                                   rng=np.random.default_rng(1))
    perm = np.random.default_rng(0).permutation(pts.shape[0])
    return cfg, pts, valid, pts[perm], valid[perm]


def _assert_same(a, b, atol):
    """Every field of two NamedTuples of arrays: exact for integer/bool
    fields, ``atol`` for float ones."""
    for name in a._fields:
        if hasattr(getattr(a, name), "_fields"):
            _assert_same(getattr(a, name), getattr(b, name), atol)
            continue
        x, y = N(getattr(a, name)), N(getattr(b, name))
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_projection_matches_jax(scene):
    cfg, pts, valid, spts, svalid = scene
    # Same winner per pixel (integer scatter-min): xyz exact; range and
    # relative time through fp32 sqrt/atan2 (an ulp).
    _assert_same(tproj.project(T(spts), T(svalid), cfg.lidar),
                 jproj.project(jnp.asarray(spts), jnp.asarray(svalid),
                               cfg.lidar), atol=1e-5)
    _assert_same(tproj.project_ordered(T(pts), T(valid), cfg.lidar),
                 jproj.project_ordered(jnp.asarray(pts), jnp.asarray(valid),
                                       cfg.lidar), atol=1e-5)


def test_frontend_run_matches_jax(scene):
    """Ground, segmentation labels and the row compaction are exact; the
    range image floats within an ulp."""
    cfg, _, _, spts, svalid = scene
    out_t = tfront.run(cfg, T(spts), T(svalid))
    out_j = jfront.run(cfg, jnp.asarray(spts), jnp.asarray(svalid))
    _assert_same(out_t, out_j, atol=1e-5)
    assert int(out_t.seg.is_cluster.sum()) > 100


def test_segmentation_matches_bfs_reference(scene):
    """The port's component structure against a plain python BFS on the
    same connectivity (imageProjection.cpp:370-460), as
    tests/test_frontend.py checks the JAX package."""
    cfg, _, _, spts, svalid = scene
    img = tproj.project(T(spts), T(svalid), cfg.lidar)
    g = tground.ground_mask(img, cfg.lidar, cfg.seg)
    lab = N(tseg.segment(img, g, cfg.lidar, cfg.seg).label)
    H, W = img.rng.shape
    r = N(img.rng)
    active = N(img.valid) & ~N(g)
    theta = math.radians(cfg.seg.segment_theta_deg)
    ax, ay = cfg.lidar.ang_res_x_rad, cfg.lidar.ang_res_y_rad

    def connected(a, b, alpha):
        d1, d2 = max(a, b), min(a, b)
        return math.atan2(d2 * math.sin(alpha),
                          d1 - d2 * math.cos(alpha)) > theta

    ref = -np.ones((H, W), np.int64)
    comp = 0
    for i in range(H):
        for j in range(W):
            if active[i, j] and ref[i, j] < 0:
                stack = [(i, j)]
                ref[i, j] = comp
                while stack:
                    a, b = stack.pop()
                    for di, dj, alpha in ((0, 1, ax), (0, -1, ax),
                                          (1, 0, ay), (-1, 0, ay)):
                        ni, nj = a + di, (b + dj) % W
                        if 0 <= ni < H and active[ni, nj] and \
                                ref[ni, nj] < 0 and \
                                connected(r[a, b], r[ni, nj], alpha):
                            ref[ni, nj] = comp
                            stack.append((ni, nj))
                comp += 1
    assert comp > 3
    for c in range(comp):
        m = ref == c
        npix, nrows = m.sum(), len(np.unique(np.nonzero(m)[0]))
        ok = npix >= cfg.seg.min_cluster_size or (
            npix >= cfg.seg.valid_point_num and
            nrows >= cfg.seg.valid_line_num)
        ours = np.unique(lab[m])
        if ok:
            assert len(ours) == 1 and ours[0] >= 0, f"component {c} split"
        else:
            assert (ours == -1).all(), f"component {c} should be outlier"


@pytest.mark.parametrize("dim", [0, 1])
def test_segmented_min_scan(dim):
    """``_seg_cummin`` (the port's stand-in for lax.associative_scan)
    against a running min restarted at every segment start."""
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 1 << 17, (16, 40)).astype(np.int32)
    starts = rng.random((16, 40)) < 0.2
    fwd = N(tseg._seg_cummin(T(vals), T(starts), dim))
    rev = N(tseg._seg_cummin_rev(T(vals), T(starts), dim))
    v, s = (vals, starts) if dim == 1 else (vals.T, starts.T)
    f, rv = (fwd, rev) if dim == 1 else (fwd.T, rev.T)
    for row in range(v.shape[0]):
        cur = None
        for i in range(v.shape[1]):
            cur = v[row, i] if (cur is None or s[row, i]) else \
                min(cur, v[row, i])
            assert f[row, i] == cur
        cur = None
        for i in reversed(range(v.shape[1])):
            cur = v[row, i] if (cur is None or s[row, i]) else \
                min(cur, v[row, i])
            assert rv[row, i] == cur


def test_compaction_keeps_column_order(scene):
    cfg, _, _, spts, svalid = scene
    out = tfront.run(cfg, T(spts), T(svalid))
    cloud = out.cloud
    cnt, v, col = N(cloud.count), N(cloud.valid), N(cloud.col)
    for i in range(cfg.lidar.n_scan):
        assert v[i, :cnt[i]].all() and not v[i, cnt[i]:].any()
        assert (np.diff(col[i, :cnt[i]]) > 0).all()
    seg, outl = tcompaction.compact(out.image, out.seg, out.ground,
                                    cfg.lidar, cfg.seg)
    assert torch.equal(seg.xyz, cloud.xyz) and \
        torch.equal(outl.count, out.outlier.count)
