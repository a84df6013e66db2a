"""The port's own ``config`` and ``utils/synthetic`` against the JAX
package's: the preset configs equal field by field, the synthetic
generator's arrays equal bit for bit (also when the rays are cast in worker
processes)."""

import dataclasses

import numpy as np
import pytest

from sc_lego_loam_tpu import config as jcfg
from sc_lego_loam_tpu.utils import synthetic as jsyn
from sc_lego_loam_tpu_torch import config as tcfg
from sc_lego_loam_tpu_torch.utils import synthetic as tsyn


@pytest.mark.parametrize("name", ["default_config", "vlp16_config",
                                  "synthetic_config", "tiny_test_config"])
def test_preset_configs_equal(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert hash(t) == hash(t.replace())          # frozen and hashable


def test_lidar_presets_equal():
    assert tcfg.PRESETS.keys() == jcfg.PRESETS.keys()
    for k in jcfg.PRESETS:
        assert dataclasses.asdict(tcfg.PRESETS[k]) == \
            dataclasses.asdict(jcfg.PRESETS[k])
    t = tcfg.default_config()
    r = t.replace(loop=dataclasses.replace(t.loop, enabled=False))
    assert not r.loop.enabled and t.loop.enabled and r.cap == t.cap
    assert t.lidar.max_points == 65536


@pytest.mark.parametrize("kw", [
    dict(trajectory="straight", step=0.4, noise=0.01, seed=7),
    dict(trajectory="figure8", radius=12.0, loops=1.05, noise=0.01, seed=3),
    dict(trajectory="figure8", radius=30.0, loops=0.05, noise=0.01, seed=11,
         shuffle=False, skew=True),
    dict(trajectory="cloverleaf", radius=32.0, petals=4, noise=0.0, seed=5,
         shuffle=True, skew=True),
])
def test_make_sequence_bit_identical(kw):
    lidar_j, lidar_t = jcfg.tiny_test_config().lidar, \
        tcfg.tiny_test_config().lidar
    want = jsyn.make_sequence(lidar_j, 5, **kw)
    got = tsyn.make_sequence(lidar_t, 5, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_make_sequence_workers_equal_serial():
    """Casting the skewed scans' rays in two worker processes changes no
    bit: the noise and the shuffle are drawn in the parent, in order."""
    lidar = tcfg.tiny_test_config().lidar
    kw = dict(trajectory="figure8", radius=30.0, loops=0.05, noise=0.01,
              seed=11, skew=True)
    for shuffle in (False, True):
        serial = tsyn.make_sequence(lidar, 4, shuffle=shuffle, **kw)
        fanned = tsyn.make_sequence(lidar, 4, shuffle=shuffle, workers=2,
                                    **kw)
        for a, b in zip(fanned, serial):
            np.testing.assert_array_equal(a, b)


def test_raycast_and_imu_samples_equal():
    lidar = tcfg.tiny_test_config().lidar
    world_j, world_t = jsyn.default_world(seed=3), tsyn.default_world(seed=3)
    pose = tsyn.figure8_trajectory(8, radius=12.0)[3]
    pj, vj = jsyn.raycast(world_j, pose, jcfg.tiny_test_config().lidar,
                          noise=0.01, rng=np.random.default_rng(4))
    pt, vt = tsyn.raycast(world_t, pose, lidar, noise=0.01,
                          rng=np.random.default_rng(4))
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(vt, vj)
    poses = tsyn.straight_trajectory(6, yaw_rate=0.02)
    for a, b in zip(tsyn.make_imu_samples(poses, seed=2),
                    jsyn.make_imu_samples(poses, seed=2)):
        np.testing.assert_array_equal(a, b)
