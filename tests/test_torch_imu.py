"""``sc_lego_loam_tpu_torch/imu.py`` against ``sc_lego_loam_tpu/imu.py``: the
same sample streams, made from a seed with numpy, pushed into both buffers,
and every reader of the buffer on the same query times.

Tolerances: the sample fields and ``count`` are copies and must be equal;
``shift`` / ``velo`` are fp32 sums taken in another order (a masked sum per
row where the JAX package adds sample by sample) and agree to 1e-6 absolute
on these streams (values up to ~0.1 m and ~1 m/s); everything read out of
the buffer agrees to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu import imu as ji
from sc_lego_loam_tpu_torch import imu as ti

torch.set_num_threads(1)

SUM_ATOL = 1e-6
READ_ATOL = 1e-5
G = np.float32([0.0, 0.0, 9.81])


def T(x):
    return torch.from_numpy(np.array(x))


def _stream(seed, n, dts):
    """n samples whose time steps are drawn from ``dts``."""
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.choice(dts, size=n)).astype(np.float32)
    # A smooth attitude (a random walk of ~0.2 deg a sample), as a moving
    # sensor's: the interpolation weight is an fp32 quotient of nearby
    # times, and its last bits scale with the step between two samples.
    rpy = np.cumsum(rng.normal(0, 0.003, (n, 3)), 0).astype(np.float32)
    acc = (rng.normal(0, 2.0, (n, 3)) + G).astype(np.float32)
    gyro = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    return ts, rpy, acc, gyro


def _push_both(jb, tb, sample, valid):
    ts, rpy, acc, gyro = sample
    jb = ji.push_many(jb, *(jnp.asarray(a) for a in (ts, rpy, acc, gyro)),
                      jnp.asarray(valid))
    tb = ti.push_many(tb, T(ts), T(rpy), T(acc), T(gyro), T(valid))
    return jb, tb


def _assert_buffers(jb, tb):
    for name in ("time", "rpy", "acc", "gyro", "count"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    for name in ("shift", "velo"):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   np.asarray(getattr(jb, name)),
                                   rtol=0, atol=SUM_ATOL, err_msg=name)
    assert tb.count.dtype == torch.int32


# name -> (que_len, batch pad, batches, time steps drawn, valid rule)
STREAMS = {
    # The engine's shape: a valid prefix, padding behind it.
    "prefix_padding": (64, 32, 3, [0.01], "prefix"),
    # Stale (0.2 s gap), out-of-order (negative step) and repeated (zero
    # step) samples reset the dead reckoning.
    "stale_and_out_of_order": (64, 16, 4, [0.01, 0.01, 0.01, 0.2, -0.005,
                                            0.0], "prefix"),
    # More samples than slots: the ring wraps, twice.
    "ring_wrap": (16, 8, 6, [0.01, 0.01, 0.02, 0.15], "prefix"),
    # Valid rows anywhere in the batch, not only in front.
    "scattered_valid": (32, 16, 3, [0.01, 0.01, 0.12], "random"),
    # A batch longer than the ring itself.
    "batch_longer_than_ring": (8, 20, 2, [0.01, 0.03], "all"),
}


def _pushed(name):
    que_len, pad, batches, dts, rule = STREAMS[name]
    rng = np.random.default_rng(len(name))
    jb, tb = ji.init_buffer(que_len), ti.init_buffer(que_len, "cpu")
    t_end = 0.0
    for b in range(batches):
        ts, rpy, acc, gyro = _stream(100 * len(name) + b, pad, dts)
        ts = (ts + np.float32(t_end)).astype(np.float32)
        if rule == "prefix":
            valid = np.arange(pad) < rng.integers(0, pad + 1)
        elif rule == "random":
            valid = rng.random(pad) < 0.6
        else:
            valid = np.ones(pad, bool)
        if valid.any():
            t_end = float(ts[valid][-1])
        jb, tb = _push_both(jb, tb, (ts, rpy, acc, gyro), valid)
        _assert_buffers(jb, tb)
    return jb, tb, t_end


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_push_many_matches_jax(name):
    jb, tb, _ = _pushed(name)
    assert int(tb.count) > 0


def test_padding_rows_leave_every_field_untouched():
    """A batch with no valid row returns the same buffer, count included;
    the padding's (zero) times never reach a slot."""
    _, tb, _ = _pushed("prefix_padding")
    ts, rpy, acc, gyro = _stream(5, 32, [0.01])
    out = ti.push_many(tb, T(ts), T(rpy), T(acc), T(gyro),
                       torch.zeros(32, dtype=torch.bool))
    for old, new in zip(tb, out):
        assert torch.equal(old, new)


def test_push_one_sample_matches_jax():
    """``push`` (a batch of one) against the JAX package's per-sample push:
    one sample at a time the sums have a single order, so shift and velo
    are held to 1e-7."""
    ts, rpy, acc, gyro = _stream(3, 40, [0.01, 0.01, 0.3, -0.01])
    jb, tb = ji.init_buffer(32), ti.init_buffer(32, "cpu")
    for k in range(len(ts)):
        jb = ji.push(jb, jnp.float32(ts[k]), jnp.asarray(rpy[k]),
                     jnp.asarray(acc[k]), jnp.asarray(gyro[k]))
        tb = ti.push(tb, T(ts[k]), T(rpy[k]), T(acc[k]), T(gyro[k]))
    np.testing.assert_array_equal(tb.time.numpy(), np.asarray(jb.time))
    np.testing.assert_allclose(tb.shift.numpy(), np.asarray(jb.shift),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(tb.velo.numpy(), np.asarray(jb.velo),
                               rtol=0, atol=1e-7)
    assert int(tb.count) == int(jb.count) == 40


def test_stale_sample_keeps_a_nan_shift():
    """``shift[prev] * 0.0``: a NaN in the newest slot's shift survives a
    reset, in the component that held it, and the finite components reset
    to zero, as in the JAX package."""
    jb, tb, t_end = _pushed("prefix_padding")
    newest = (int(tb.count) - 1) % tb.time.shape[0]
    shift = np.asarray(jb.shift).copy()
    shift[newest, 1] = np.nan
    jb = jb._replace(shift=jnp.asarray(shift))
    tb = tb._replace(shift=T(shift))
    ts = np.float32([t_end + 0.01, t_end + 0.5, t_end + 0.51, 0.0])
    sample = (ts, np.zeros((4, 3), np.float32),
              np.tile(G + np.float32([1, 0, 0]), (4, 1)),
              np.zeros((4, 3), np.float32))
    jb, tb = _push_both(jb, tb, sample, np.array([1, 1, 1, 0], bool))
    got, want = tb.shift.numpy(), np.asarray(jb.shift)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=SUM_ATOL)
    rows = [(newest + k) % tb.time.shape[0] for k in (1, 2, 3)]
    assert np.isnan(got[rows, 1]).all()
    assert got[rows[1], 0] == 0.0           # the stale row's reset
    assert got[rows[2], 0] > 0.0            # ... and integration goes on


@pytest.mark.parametrize("name", ["prefix_padding", "stale_and_out_of_order",
                                  "ring_wrap"])
def test_readers_match_jax(name):
    """``_interp``, ``deskew_to_end``, ``motion_prior``, ``rpy_at`` and
    ``shift_from_start`` on the same buffer.  The out-of-order stream leaves
    the unrolled times unsorted: the bracket is found by counting in both
    packages (a sorted search would differ there)."""
    jb, tb, t_end = _pushed(name)
    rng = np.random.default_rng(7)
    q = rng.uniform(t_end - 0.4, t_end + 0.05, 64).astype(np.float32)
    for a, b in zip(ji._interp(jb, jnp.asarray(q)), ti._interp(tb, T(q))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=READ_ATOL)

    pts = rng.normal(0, 10.0, (64, 3)).astype(np.float32)
    rel = rng.random(64).astype(np.float32)
    start, v = np.float32(t_end - 0.1), np.float32([1.0, -2.0, 0.5])
    want = ji.deskew_to_end(jb, jnp.asarray(pts), jnp.asarray(rel),
                            jnp.float32(start), 0.1, jnp.asarray(v))
    got = ti.deskew_to_end(tb, T(pts), T(rel), T(start), 0.1, T(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=READ_ATOL)

    t0, t1 = np.float32(t_end - 0.1), np.float32(t_end)
    np.testing.assert_allclose(
        ti.motion_prior(tb, T(t0), T(t1)).numpy(),
        np.asarray(ji.motion_prior(jb, jnp.float32(t0), jnp.float32(t1))),
        rtol=0, atol=READ_ATOL)
    np.testing.assert_allclose(
        ti.shift_from_start(tb, T(t0), T(t1)).numpy(),
        np.asarray(ji.shift_from_start(jb, jnp.float32(t0), jnp.float32(t1))),
        rtol=0, atol=READ_ATOL)
    tq = np.float32(t_end - 0.033)
    np.testing.assert_allclose(
        ti.rpy_at(tb, T(tq)).numpy(),
        np.asarray(ji.rpy_at(jb, jnp.float32(tq))), rtol=0, atol=READ_ATOL)


def test_interp_on_an_empty_buffer_is_finite():
    for a, b in zip(ji._interp(ji.init_buffer(8), jnp.float32([0.0, 1.0])),
                    ti._interp(ti.init_buffer(8, "cpu"),
                               T(np.float32([0.0, 1.0])))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# The four cases of tests/test_imu.py, on the port.

def _flat_buffer(n, que_len, rpy_of=lambda t: (0.0, 0.0, 0.0),
                 acc=(0.0, 0.0, 9.81)):
    buf = ti.init_buffer(que_len, "cpu")
    for k in range(n):
        t = k * 0.01
        buf = ti.push(buf, torch.tensor(t), torch.tensor(rpy_of(t)),
                      torch.tensor(acc), torch.zeros(3))
    return buf


def test_push_integrates_constant_velocity():
    buf = _flat_buffer(10, 32)
    np.testing.assert_allclose(buf.velo[9].numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(buf.shift[9].numpy(), 0.0, atol=1e-6)


def test_push_integrates_acceleration():
    n, dt = 20, 0.01
    buf = _flat_buffer(n, 64, acc=(1.0, 0.0, 9.81))     # 1 m/s^2 forward
    t = (n - 1) * dt
    np.testing.assert_allclose(float(buf.velo[n - 1][0]), t, atol=1e-3)
    np.testing.assert_allclose(float(buf.shift[n - 1][0]), 0.5 * t * t,
                               atol=1e-3)


def test_deskew_to_end_removes_rotation():
    """Sensor yaws during the scan: a point captured mid-scan is rotated
    into the scan-END frame (stationary sensor, v_world = 0)."""
    yaw_rate = 0.5
    buf = _flat_buffer(30, 64, rpy_of=lambda t: (0.0, 0.0, yaw_rate * t))

    def Rz(yaw):
        c, s = np.cos(yaw), np.sin(yaw)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    p_world = np.array([10.0, 0.0, 0.0], np.float32)
    p_sensor = Rz(yaw_rate * 0.15).T @ p_world       # captured at t = 0.15
    out = ti.deskew_to_end(buf, T(p_sensor[None]), T(np.float32([0.5])),
                           torch.tensor(0.1), 0.1, torch.zeros(3))
    np.testing.assert_allclose(out.numpy()[0], Rz(yaw_rate * 0.2).T @ p_world,
                               atol=0.02)


def test_deskew_to_end_translation_via_velocity_estimate():
    """Constant velocity: the IMU deviation term is zero, so the caller's
    v_world carries the whole correction."""
    buf = _flat_buffer(30, 64)
    v = np.array([5.0, 0.0, 0.0], np.float32)
    p_world = np.array([10.0, 3.0, 1.0], np.float32)
    p_sensor = p_world - v * (0.1 + 0.25 * 0.1)
    out = ti.deskew_to_end(buf, T(p_sensor[None]), T(np.float32([0.25])),
                           torch.tensor(0.1), 0.1, T(v))
    np.testing.assert_allclose(out.numpy()[0], p_world - v * 0.2, atol=1e-3)
