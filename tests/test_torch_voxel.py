"""The exact, sort-based centroid downsample (``ops/voxel.voxel_keys``,
``voxel_downsample``, ``downsample_count``) against the JAX package's, case
by case as tests/test_features.py uses it: two points in one voxel and one
alone, extras averaged alongside, ties (repeated points, points on voxel
faces, negative coordinates), an empty mask, more voxels than ``out_pad``
and an ``out_pad`` past the cloud's length."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu.ops import voxel as jv
from sc_lego_loam_tpu_torch.ops import voxel as tv

torch.set_num_threads(1)


def _case(name):
    rng = np.random.default_rng(5)
    if name == "centroids":        # tests/test_features.py:30
        pts = np.array([[0.05, 0.05, 0.05], [0.15, 0.05, 0.05],
                        [1.05, 0.0, 0.0], [9.0, 9.0, 9.0]], np.float32)
        return pts, np.array([True, True, True, False]), 0.2, 8, None
    if name == "extras":           # tests/test_features.py:46, and more
        pts = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
        ex = rng.normal(size=(40, 2)).astype(np.float32)
        return pts, rng.random(40) > 0.2, 0.5, 16, ex
    if name == "ties":
        base = np.array([[0.0, 0.0, 0.0], [0.5, -0.5, 1.0], [-1.0, 2.0, 0.5],
                         [0.49999997, 0.0, 0.0]], np.float32)
        pts = np.concatenate([base, base, base[::-1], -base])
        return pts, np.ones(len(pts), bool), 0.5, 32, pts[:, :1] * 2
    if name == "empty":
        pts = rng.uniform(-5, 5, (20, 3)).astype(np.float32)
        return pts, np.zeros(20, bool), 0.3, 8, pts[:, :2]
    if name == "overflow":
        pts = rng.uniform(-4, 4, (300, 3)).astype(np.float32)
        return pts, rng.random(300) > 0.1, 0.4, 16, None
    pts = rng.uniform(-2, 2, (50, 3)).astype(np.float32)     # "long_pad"
    return pts, rng.random(50) > 0.5, 0.7, 80, pts * 3


@pytest.mark.parametrize("name", ["centroids", "extras", "ties", "empty",
                                  "overflow", "long_pad"])
def test_voxel_downsample_matches_jax(name):
    pts, mask, leaf, pad, ex = _case(name)
    tex = None if ex is None else torch.from_numpy(ex)
    jex = None if ex is None else jnp.asarray(ex)
    np.testing.assert_array_equal(
        tv.voxel_keys(torch.from_numpy(pts), torch.from_numpy(mask),
                      leaf).numpy(),
        np.asarray(jv.voxel_keys(jnp.asarray(pts), jnp.asarray(mask), leaf)))
    got = tv.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(mask),
                              leaf, pad, extras=tex)
    want = jv.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), leaf,
                               pad, extras=jex)
    assert tuple(got[0].shape) == want[0].shape == (min(pad, len(pts)), 3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6)
    assert (got[2] is None) == (want[2] is None)
    if ex is not None:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   atol=1e-6)
    n = tv.downsample_count(got[1])
    assert n.dtype == torch.int32
    assert int(n) == int(jv.downsample_count(want[1]))
    if name == "centroids":
        o = sorted(got[0].numpy()[got[1].numpy()].tolist())
        np.testing.assert_allclose(o, [[0.1, 0.05, 0.05], [1.05, 0.0, 0.0]],
                                   atol=1e-6)
    if name == "empty":
        assert int(n) == 0 and not got[0].any()
