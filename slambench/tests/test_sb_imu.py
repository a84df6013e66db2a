"""The IMU stream of a drive: the harness's caster against the port's host
synthesizer, a drive without a stream served as before, and the
configurations the harness refuses to load."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch.config import tiny_test_config
from sc_lego_loam_tpu_torch.utils import synthetic
from slambench import caster, session
from sb_tiny import add_cell, copy_tree

LIDAR = dataclasses.asdict(tiny_test_config().lidar)
FIG8 = {"trajectory": "figure8", "radius": 30.0, "height": 2.0,
        "scans_per_lap": 240 / 1.05, "noise": 0.01,
        "world": {"extent": 90.0, "n_boxes": 40, "n_cylinders": 60},
        "worlds": [11, 12]}
CLOVER = dict(FIG8, trajectory="cloverleaf", radius=32.0, petals=4,
              scans_per_lap=520)
STREAM = {"rate_hz": 100.0, "noise_rpy": 0.003, "noise_acc": 0.05,
          "noise_gyro": 0.003}
QUIET = dict(STREAM, noise_rpy=0.0, noise_acc=0.0, noise_gyro=0.0)


@pytest.mark.parametrize("traffic", (FIG8, CLOVER),
                         ids=("figure8", "cloverleaf"))
def test_noise_free_stream_matches_port(traffic):
    """(a) With no noise, ``caster.imu_samples`` is the port's
    ``make_imu_samples`` on the same poses.  Tolerance 1e-5: the port
    rounds its channels to float32 (accelerations near 12 m/s^2 by up to
    1e-6); the two float64 computations agree to ~1e-12.  Angles are
    compared modulo 2 pi: a yaw at pi may come out as -pi on either."""
    P = caster.trajectory(traffic, 41, "cpu")
    gen = torch.Generator().manual_seed(0)
    times, rpy, acc, gyro = (x.numpy() for x in
                             caster.imu_samples(P, QUIET, gen))
    t2, rpy2, acc2, gyro2 = synthetic.make_imu_samples(
        P.numpy(), t0=0.0, period=caster.SCAN_PERIOD, rate_hz=100.0,
        noise_rpy=0.0, noise_acc=0.0, noise_gyro=0.0)
    assert len(times) == len(t2) == 401
    np.testing.assert_array_equal(times, t2)
    wrapped = (rpy - rpy2 + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(wrapped, 0.0, atol=1e-5)
    np.testing.assert_allclose(acc, acc2, atol=1e-5)
    np.testing.assert_allclose(gyro, gyro2, atol=1e-5)
    # Gravity is in the readings: a level vehicle reads ~9.81 up.
    assert np.abs(acc[:, 2] - caster.GRAVITY).max() < 0.5


def test_stream_is_seeded_and_due_by_scan_end():
    n = 12
    a = caster.make_drive(LIDAR, FIG8, 2 ** 40 + 5, n, 1, "cpu", STREAM)
    b = caster.make_drive(LIDAR, FIG8, 2 ** 40 + 5, n, 1, "cpu", STREAM)
    c = caster.make_drive(LIDAR, FIG8, 2 ** 40 + 6, n, 1, "cpu", STREAM)
    imu = a.imu
    assert imu.rpy.shape == imu.acc.shape == imu.gyro.shape == (
        10 * n + 1, 1, 3) and imu.rpy.dtype == np.float32
    for k in ("times", "rpy", "acc", "gyro", "ends"):
        np.testing.assert_array_equal(getattr(imu, k), getattr(b.imu, k))
    assert not np.array_equal(imu.acc, c.imu.acc)
    # Scan i ends at (i + 1) periods: 11 samples before scan 0 (t = 0 to
    # 0.1 s), 10 before every later one, the last at the scan's end.
    assert imu.ends[0] == 11 and (np.diff(imu.ends) == 10).all()
    np.testing.assert_allclose(imu.times[imu.ends - 1],
                               (np.arange(n) + 1) * caster.SCAN_PERIOD)
    # The noise is the stream's own: around the noise-free channels by
    # its standard deviations.
    P = caster.trajectory(FIG8, n + 1, "cpu")
    _, rpy, acc, gyro = caster.imu_samples(P, QUIET, None)
    assert 0.03 < np.std(imu.acc[:, 0] - acc.numpy()) < 0.07
    assert 0.002 < np.std(imu.gyro[:, 0] - gyro.numpy()) < 0.004


def test_drive_without_a_stream_is_served_as_before():
    """(c) No ``imu_stream``: the scans are the cast's alone, bit for bit
    (the stream's draws do not touch them), ``drive.imu`` is None, and
    ``System.step`` hands the engine the scan and nothing else."""
    seed, n = 2 ** 33 + 9, 5
    plain = caster.make_drive(LIDAR, FIG8, seed, n, 2, "cpu")
    fed = caster.make_drive(LIDAR, FIG8, seed, n, 2, "cpu", STREAM)
    assert plain.imu is None and fed.imu is not None
    np.testing.assert_array_equal(plain.scans, fed.scans)
    np.testing.assert_array_equal(plain.valids, fed.valids)
    # The cast as the harness made it before it had IMU streams.
    P = caster.trajectory(FIG8, n + 1, "cpu")
    for s, ns in enumerate(caster.stream_seeds(seed, 2)):
        boxes, cyls = caster.world_arrays(FIG8["worlds"][s])
        pts, valid = caster.cast(LIDAR, P, ns, FIG8["noise"],
                                 torch.as_tensor(boxes),
                                 torch.as_tensor(cyls))
        np.testing.assert_array_equal(plain.scans[:, s], pts.numpy())
        np.testing.assert_array_equal(plain.valids[:, s], valid.numpy())

    calls = []

    class Engine:
        def process_scan(self, points, mask, t):
            calls.append(("process_scan", points, mask, t))
            return torch.eye(4)

        def push_imu_batch(self, *args):
            calls.append(("push_imu_batch",))

    system = types.SimpleNamespace(kind="single", engine=Engine(),
                                   push_ms={})
    for i in range(n):
        session.System.step(system, plain, i)
    assert [c[0] for c in calls] == ["process_scan"] * n
    for i, (_, points, mask, t) in enumerate(calls):
        np.testing.assert_array_equal(points, plain.scans[i, 0])
        np.testing.assert_array_equal(mask, plain.valids[i, 0])
        assert t == i * caster.SCAN_PERIOD
    assert system.push_ms == {}
    # With a stream, one push of the samples due by the scan's end first.
    calls.clear()
    for i in range(n):
        session.System.step(system, fed, i)
    assert [c[0] for c in calls] == ["push_imu_batch",
                                     "process_scan"] * n
    assert list(system.push_ms) == list(range(n))


@pytest.mark.parametrize("case", ("stream_without_imu", "imu_without_stream",
                                  "fleet_with_imu"))
def test_disagreeing_configurations_fail_to_load(tmp_path, case):
    """(d) An ``imu_stream`` without ``pipeline.imu.enabled``, the IMU on
    without a stream, or a fleet with the IMU on: refused with a
    message."""
    dst = str(tmp_path)
    copy_tree(dst)
    kw = {"stream_without_imu": dict(imu_stream=STREAM, imu_enabled=False),
          "imu_without_stream": dict(imu_enabled=True),
          "fleet_with_imu": dict(imu_stream=STREAM, engine="batch",
                                 streams=2)}[case]
    with pytest.raises(ValueError, match="(?i)imu"):
        add_cell(dst, "bad", **kw)
