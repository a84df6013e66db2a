"""IMU integration & de-skew support (port of ``sc_lego_loam_tpu/imu.py``;
reference featureAssociation.cpp:327-619).

The reference keeps a 200-entry circular IMU buffer (utility.h:113), dead-
reckons gravity-compensated shift / velocity (fA.cpp:392-429) and de-skews
each point by interpolating orientation and shift to its capture time
(fA.cpp:327-390, 525-618).

Here the buffer is a NamedTuple of fixed-shape tensors.  A batch of samples
is integrated without a loop over its rows: the dead-reckoning recurrence
(x += v dt + a dt^2 / 2, v += a dt, both reset by a stale sample) is linear
with resets, so every row's value is its segment's masked sum (``_push_rows``).
That is one fixed set of small launches per batch whatever its length
(``chip_smoke.py`` prints the count), against ~15 per sample for a loop, and
sums in another fp32 order than a sample-by-sample push (a few ulp).  Per-point de-skew is one gather + lerp against the buffer.
No function reads a device value on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .utils import se3


class ImuBuffer(NamedTuple):
    """Circular buffer of IMU samples (fixed capacity)."""

    time: torch.Tensor     # (Q,) seconds
    rpy: torch.Tensor      # (Q,3) roll,pitch,yaw (world orientation)
    acc: torch.Tensor      # (Q,3) body-frame linear acceleration (m/s^2)
    gyro: torch.Tensor     # (Q,3) body angular velocity (rad/s)
    # Dead-reckoned trajectory (AccumulateIMUShiftAndRotation analog):
    shift: torch.Tensor    # (Q,3) world position
    velo: torch.Tensor     # (Q,3) world velocity
    count: torch.Tensor    # () int32 total samples seen (head = count % Q)


def init_buffer(que_len: int, device) -> ImuBuffer:
    def z():
        return torch.zeros((que_len, 3), dtype=torch.float32, device=device)

    return ImuBuffer(
        time=torch.full((que_len,), -1e18, dtype=torch.float32, device=device),
        rpy=z(), acc=z(), gyro=z(), shift=z(), velo=z(),
        count=torch.zeros((), dtype=torch.int32, device=device))


def world_acceleration(rpy, acc_raw, g: float = 9.81):
    """Rotate body acceleration to world and remove gravity
    (fA.cpp:438-440)."""
    R = se3.euler_zyx_to_mat(rpy[..., 2], rpy[..., 1], rpy[..., 0])
    acc_w = (R @ acc_raw[..., None])[..., 0]
    return torch.cat([acc_w[..., :2], acc_w[..., 2:] - g], -1)


def _last_marked(mark):
    """(P,) bool -> (P,) int64: the highest row j <= k with ``mark[j]``,
    or -1."""
    rows = torch.arange(mark.shape[0], device=mark.device)
    return torch.cummax(torch.where(mark, rows, -1), 0).values


def _push_rows(buf: ImuBuffer, ts, rpys, accs, gyros, valid) -> ImuBuffer:
    """``push_many`` for at most Q rows (so no two rows share a slot)."""
    Q, P = buf.time.shape[0], ts.shape[0]
    dev = ts.device
    rows = torch.arange(P, device=dev)
    count = buf.count.to(torch.int64)
    acc_w = world_acceleration(rpys, accs)                       # (P,3)

    # Every valid row's predecessor: the valid row before it in the batch,
    # or the buffer's newest slot for the first.
    before = torch.cat([torch.full((1,), -1, device=dev),
                        _last_marked(valid)[:-1]])               # (P,)
    in_batch = before >= 0
    b_idx = torch.clamp(before, min=0)
    slot0 = torch.remainder(count - 1, Q).reshape(1)
    n_before = count + torch.cumsum(valid, 0) - 1     # samples seen earlier
    dt = ts - torch.where(in_batch, ts[b_idx], buf.time[slot0])
    fresh = (n_before > 0) & (dt < 0.1) & (dt > 0)    # scanPeriod guard
    dt3 = dt[:, None]

    # A row's segment: the valid rows after the last stale one, up to it.
    # A stale row zeroes the velocity and multiplies the shift by zero
    # (which keeps a NaN); a row with no stale row before it in the batch
    # continues from the buffer.
    start = _last_marked(valid & ~fresh)                         # (P,)
    from_buf = (start < 0)[:, None]
    seg = ((rows[None, :] > start[:, None]) & (rows[None, :] <= rows[:, None])
           & valid[None, :])[..., None]                          # (P,P,1)

    def seg_sum(x):
        return torch.where(seg, x[None], 0.0).sum(1)

    velo = torch.where(from_buf, buf.velo[slot0], 0.0) + seg_sum(acc_w * dt3)
    velo_before = torch.where(in_batch[:, None], velo[b_idx], buf.velo[slot0])
    step = seg_sum(velo_before * dt3 + 0.5 * acc_w * dt3 * dt3)
    # A non-finite shift stays non-finite through every later row: as a
    # NaN after a reset (x * 0), as it is plus the steps otherwise.
    broken = torch.cummax((~torch.isfinite(step)
                           & valid[:, None]).to(torch.int8), 0).values > 0
    broken_before = torch.where(
        (start > 0)[:, None], broken[torch.clamp(start - 1, min=0)], False) \
        | ~torch.isfinite(buf.shift[slot0])
    zero = torch.where(broken_before, math.nan, 0.0)
    shift = torch.where(from_buf, buf.shift[slot0], zero) + step

    # Row k goes to slot (count + its rank among the valid rows) % Q.
    hit = valid[:, None] & (torch.remainder(n_before, Q)[:, None]
                            == torch.arange(Q, device=dev)[None, :])  # (P,Q)
    written = hit.any(0)
    src = hit.to(torch.int8).argmax(0)

    def put(old, new):
        picked = new[src]
        return torch.where(written if old.dim() == 1 else written[:, None],
                           picked, old)

    return ImuBuffer(
        time=put(buf.time, ts), rpy=put(buf.rpy, rpys),
        acc=put(buf.acc, accs), gyro=put(buf.gyro, gyros),
        shift=put(buf.shift, shift), velo=put(buf.velo, velo),
        count=buf.count + valid.sum(dtype=torch.int32))


def push_many(buf: ImuBuffer, ts, rpys, accs, gyros, valid) -> ImuBuffer:
    """Insert a PADDED batch of samples: ``ts`` (P,), ``rpys`` / ``accs`` /
    ``gyros`` (P,3), ``valid`` (P,) bool.  Rows with ``valid`` false leave
    every field untouched, ``count`` included.  Each valid row dead-reckons
    shift / velocity from the sample before it (fA.cpp:392-429) unless it
    is stale (not within (0, 0.1) s of that sample), which resets both."""
    Q = buf.time.shape[0]
    for lo in range(0, ts.shape[0], Q):
        hi = lo + Q
        buf = _push_rows(buf, ts[lo:hi], rpys[lo:hi], accs[lo:hi],
                         gyros[lo:hi], valid[lo:hi])
    return buf


def push(buf: ImuBuffer, t, rpy, acc_raw, gyro) -> ImuBuffer:
    """Insert one sample (a batch of one row)."""
    valid = torch.ones(1, dtype=torch.bool, device=buf.time.device)
    return push_many(buf, t.reshape(1), rpy[None], acc_raw[None], gyro[None],
                     valid)


def _interp(buf: ImuBuffer, ts: torch.Tensor):
    """Linear interpolation of (rpy, shift, velo) at query times ts (N,).

    The bracketing samples are found by COUNTING the buffered times at or
    below each query over the unrolled order (head, head+1, ..., head-1),
    not by a sorted search: an out-of-order or repeated sample leaves the
    unrolled times unsorted, and the count is still defined."""
    Q = buf.time.shape[0]
    head = torch.remainder(buf.count.to(torch.int64), Q)
    order = torch.remainder(torch.arange(Q, device=ts.device) + head, Q)
    times = buf.time[order]
    valid = times > -1e17
    le = (times[None, :] <= ts[:, None]) & valid[None, :]
    # Empty slots carry time -1e18 and sit at the front of the unrolled
    # order; offset indices past them.
    n_invalid = (~valid).sum()
    i0 = torch.clamp(n_invalid + le.sum(-1) - 1, 0, Q - 1)  # last sample <= t
    i1 = torch.clamp(i0 + 1, max=Q - 1)
    t0 = times[i0]
    t1 = times[i1]
    w = torch.where(t1 > t0, (ts - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0)
    w = torch.clamp(w, 0.0, 1.0)[:, None]

    def lerp(a):
        a = a[order]
        return a[i0] * (1 - w) + a[i1] * w

    return lerp(buf.rpy), lerp(buf.shift), lerp(buf.velo)


def deskew_to_end(buf: ImuBuffer, points: torch.Tensor,
                  rel_time: torch.Tensor, scan_start: torch.Tensor,
                  scan_period: float, v_world: torch.Tensor):
    """Full IMU de-skew into the scan-END frame; the caller then marks the
    cloud instantaneous (rel_time := 1).

    Per point captured at time t: the rotation R_end^T R_t from the
    interpolated IMU attitude (TransformToStartIMU, fA.cpp:365-390), and
    the translation dev(t) + v_world (t - t_end), where dev is the IMU's
    dead-reckoned deviation from constant velocity (ShiftToStartIMU,
    fA.cpp:327-345) and ``v_world`` the engine's own velocity estimate.
    As in the JAX package, ``v_world`` is in the odometry's world frame and
    is added to a deviation in the IMU's world frame.

    points: (N,3) sensor frame; rel_time: (N,) in [0,1); scan_start: ()
    absolute scan start (float32); v_world: (3,).  Returns (N,3) in the
    scan-end sensor frame."""
    ts = scan_start + rel_time * scan_period
    te = scan_start + scan_period
    rpy_t, shift_t, _ = _interp(buf, ts)
    rpy_e, shift_e, velo_e = _interp(buf, te.reshape(1))
    dt = (ts - te)[:, None]                               # (N,1), <= 0
    dev = shift_t - shift_e[0] - velo_e[0] * dt
    rel = dev + v_world[None, :] * dt                     # pos(t) - pos(te)
    R_t = se3.euler_zyx_to_mat(rpy_t[:, 2], rpy_t[:, 1], rpy_t[:, 0])
    R_e = se3.euler_zyx_to_mat(rpy_e[0, 2], rpy_e[0, 1], rpy_e[0, 0])
    p_w = (R_t @ points[..., None])[..., 0] + rel
    return p_w @ R_e          # row-vector form of R_e^T p_w


def shift_from_start(buf: ImuBuffer, scan_start, scan_end):
    """Accumulated IMU translation across one scan (fA.cpp:1639-1664)."""
    _, sh, _ = _interp(buf, torch.stack([scan_start, scan_end]))
    return sh[1] - sh[0]


def motion_prior(buf: ImuBuffer, scan_start, scan_end):
    """Dead-reckoned sensor motion over one scan as an se(3) twist: the
    scan-to-scan initial guess (updateInitialGuess, fA.cpp:1639-1664)."""
    rpy, sh, _ = _interp(buf, torch.stack([scan_start, scan_end]))
    R = se3.euler_zyx_to_mat(rpy[:, 2], rpy[:, 1], rpy[:, 0])
    R_rel = R[0].T @ R[1]
    v = R[0].T @ (sh[1] - sh[0])
    return se3.se3_log(se3.rt_to_mat(R_rel, v))


def rpy_at(buf: ImuBuffer, t):
    """World roll/pitch/yaw interpolated at time t (the transformUpdate
    blend input, mO.cpp:484-517)."""
    rpy, _, _ = _interp(buf, t.reshape(1))
    return rpy[0]
