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


# ``voxel_downsample_hash``, the engine's scan filter: its float bucket sums
# must add each bucket's points in their index order, whatever the device
# schedules (on the card a float scatter-add summed in the order its atomics
# landed, so two runs of the engine parted by centimetres within 48 scans).

def _street(seed):
    """Street-scale cloud with far points (hash collisions, int32 wrap)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-60, 60, (6000, 3)).astype(np.float32)
    pts[:500] = rng.uniform(-3000, 3000, (500, 3))
    return pts, rng.random(6000) > 0.2


def _hash_ds(pts, mask):
    return tv.voxel_downsample_hash(torch.from_numpy(pts),
                                    torch.from_numpy(mask), 0.4, 4096,
                                    table_bits=14)


def _buckets(pts, mask):
    return tv._bucket(torch.from_numpy(pts), torch.from_numpy(mask), 0.4,
                      14).numpy()


def test_voxel_hash_sums_in_point_order():
    """The centroids equal a sequential float32 sum over the points in
    index order, bit for bit; and an input whose points are permuted but
    keep their order within each bucket gives the same output, bit for
    bit (only the order inside a bucket may move a sum's last bit)."""
    pts, mask = _street(11)
    b = _buckets(pts, mask)
    sums = np.zeros((1 << 14, 3), np.float32)
    cnts = np.zeros(1 << 14, np.float32)
    for i in range(len(pts)):             # the reference: one add at a time
        if mask[i]:
            sums[b[i]] += pts[i]
            cnts[b[i]] += np.float32(1.0)
    got, ok = _hash_ds(pts, mask)
    live = np.nonzero(cnts > 0)[0][:4096]
    want = sums[live] / cnts[live][:, None]
    np.testing.assert_array_equal(ok.numpy(), np.arange(4096) < len(live))
    np.testing.assert_array_equal(got.numpy()[:len(live)], want)

    perm = np.random.default_rng(12).permutation(len(pts))
    bp = b[perm]
    for v in np.unique(bp):               # each bucket back in index order
        at = bp == v
        perm[at] = np.sort(perm[at])
    again = _hash_ds(pts[perm], mask[perm])
    np.testing.assert_array_equal(again[1].numpy(), ok.numpy())
    np.testing.assert_array_equal(again[0].numpy(), got.numpy())
    assert len(live) > 1000


_ATOMIC_SUMS = ("index_add", "scatter_add", "scatter_reduce", "index_reduce")


def test_voxel_hash_has_no_float_index_add():
    """No float sum on the filter's path that the card would add in its
    atomics' order (``index_add``, ``scatter_add``, ``scatter_reduce``,
    ``index_reduce``; an accumulating ``index_put`` sorts), and the same
    output under ``torch.use_deterministic_algorithms(True)``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.float_sums = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if name.startswith(_ATOMIC_SUMS) and \
                    args[0].is_floating_point():
                self.float_sums.append(str(func))
            return func(*args, **kwargs)

    pts, mask = _street(13)
    with Record() as rec:
        got = _hash_ds(pts, mask)
    assert rec.float_sums == []
    torch.use_deterministic_algorithms(True)
    try:
        again = _hash_ds(pts, mask)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
