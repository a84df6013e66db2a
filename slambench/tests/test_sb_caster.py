"""The benchmark's torch caster against the port's host caster
(``utils/synthetic``) at a tiny size, float64 on the CPU."""

import numpy as np
import torch

from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.utils import synthetic
from slambench import caster, reference

import dataclasses

LIDAR = dataclasses.asdict(tiny_test_config().lidar)
FIG8 = {"trajectory": "figure8", "radius": 30.0, "height": 2.0,
        "scans_per_lap": 240 / 1.05, "noise": 0.0,
        "world": {"extent": 90.0, "n_boxes": 40, "n_cylinders": 60},
        "worlds": [11, 12]}
CLOVER = dict(FIG8, trajectory="cloverleaf", radius=32.0, petals=4,
              scans_per_lap=520)


def test_world_matches_port():
    for seed in (0, 11, 2 ** 31 + 7):
        boxes, cyls = caster.world_arrays(seed)
        w = synthetic.default_world(seed)
        np.testing.assert_array_equal(boxes, w.boxes)
        np.testing.assert_array_equal(cyls, w.cylinders)


def test_trajectories_match_port():
    P = caster.trajectory(FIG8, 240, "cpu").numpy()
    np.testing.assert_allclose(
        P, synthetic.figure8_trajectory(240, radius=30.0, loops=1.05),
        atol=1e-9)
    np.testing.assert_allclose(reference.trajectory(FIG8, 240), P, atol=1e-9)
    P = caster.trajectory(CLOVER, 520, "cpu").numpy()
    np.testing.assert_allclose(
        P, synthetic.cloverleaf_trajectory(520, radius=32.0, petals=4),
        atol=1e-9)
    np.testing.assert_allclose(reference.trajectory(CLOVER, 520), P,
                               atol=1e-9)


def test_skewed_scans_match_port():
    n = 6
    lidar = tiny_test_config().lidar
    scans, valids, gt = synthetic.make_sequence(
        lidar, n, trajectory="figure8", noise=0.0, seed=11, shuffle=False,
        skew=True, radius=30.0,
        loops=(n + 1) / FIG8["scans_per_lap"])   # n + 1 poses for n skewed scans
    drive = caster.make_drive(LIDAR, FIG8, 2 ** 40 + 1, n, 1, "cpu")
    assert drive.scans.shape == (n, 1) + scans.shape[1:]
    np.testing.assert_array_equal(drive.valids[:, 0], valids)
    np.testing.assert_allclose(drive.scans[:, 0], scans, atol=1e-4)
    np.testing.assert_allclose(reference.ground_truth(FIG8, n), gt,
                               atol=1e-5)


def test_noise_is_seeded_and_sized():
    traffic = dict(FIG8, noise=0.01)
    a = caster.make_drive(LIDAR, traffic, 5, 3, 2, "cpu")
    b = caster.make_drive(LIDAR, traffic, 5, 3, 2, "cpu")
    c = caster.make_drive(LIDAR, dict(FIG8), 5, 3, 2, "cpu")
    np.testing.assert_array_equal(a.scans, b.scans)
    assert a.seeds == b.seeds and len(set(a.seeds)) == 2
    # The worlds are the mix's: another seed, other noise, the same scene.
    e = caster.make_drive(LIDAR, traffic, 6, 3, 2, "cpu")
    np.testing.assert_array_equal(e.valids, a.valids)
    assert not np.array_equal(e.scans, a.scans)
    d = (a.scans - c.scans)[c.valids]
    r = np.linalg.norm(c.scans[c.valids], axis=-1)
    # Range noise along each ray: 0.01 m.
    assert 0.007 < np.std(np.linalg.norm(a.scans[c.valids], axis=-1) - r) \
        < 0.013
    assert np.abs(d).max() < 0.1


def test_chunking_changes_nothing():
    boxes, cyls = caster.world_arrays(3)
    P = caster.trajectory(FIG8, 5, "cpu")
    kw = dict(boxes=torch.as_tensor(boxes), cyls=torch.as_tensor(cyls))
    a = caster.cast(LIDAR, P, 3, 0.0, chunk=1, **kw)
    b = caster.cast(LIDAR, P, 3, 0.0, chunk=8, **kw)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert torch.equal(a[1], b[1])
