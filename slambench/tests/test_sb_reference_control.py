"""The reference control, for a cell whose program has no lower-precision
path that changes its arithmetic: the reference put in the program's
place, a perfect odometer chaining the true steps in TF32, at the
headline cell's size.  It must fail the cell's limits; the same chain in
float32 must pass them."""

import json
import os

import numpy as np

from slambench import judge, reference as ref
from sb_tiny import HERE

CELL = "mulran-os1-64.fig8.replay"
STEPS = 760          # a 30 s window at ~25 scans/s, + warm-up


def _pose6(T):
    """4x4 -> (roll, pitch, yaw, x, y, z), R = Rz(yaw) Ry(pitch) Rx(roll)."""
    R = T[:, :3, :3]
    return np.stack([np.arctan2(R[:, 2, 1], R[:, 2, 2]),
                     -np.arcsin(np.clip(R[:, 2, 0], -1, 1)),
                     np.arctan2(R[:, 1, 0], R[:, 0, 0]),
                     T[:, 0, 3], T[:, 1, 3], T[:, 2, 3]], -1)


def _numbers(chain, factors):
    bench = json.load(open(os.path.join(os.path.dirname(HERE),
                                        "BENCHMARK.json")))
    w = {c["name"]: c for c in bench["workloads"]}[CELL]
    cfg = json.load(open(os.path.join(HERE, "configs",
                                      w["config"] + ".json")))
    traffic = json.load(open(os.path.join(HERE, "traffic",
                                          w["traffic"] + ".json")))
    limits = json.load(open(os.path.join(HERE, "limits", CELL + ".json")))
    gt = ref.ground_truth(traffic, STEPS)
    P = chain(gt)
    # A keyframe on every mapping tick (every 3rd scan), at the chain's
    # pose, its odometry factor the chain's step from the keyframe before;
    # loop factors between the laps' passes of one place.
    ticks = np.arange(0, STEPS, 3)
    pairs = np.array([[237, 9], [234, 6], [468, 12]])
    K = P[ticks]
    odom = np.concatenate([K[:1], ref.inv(K[:-1]) @ K[1:]])
    bank = {"poses6": _pose6(K), "times": ticks * 0.1, "odom_z": odom,
            "li": pairs[:, 0] // 3, "lj": pairs[:, 1] // 3,
            "lz": factors(P, pairs)}
    streams = int(cfg["streams"])
    nums, _ = judge.numbers(cfg, traffic,
                            np.repeat(P[:, None], streams, 1),
                            [bank] * streams, 7, set(ticks.tolist()))
    return judge.verdict(nums, limits), nums


def test_reference_control_fails():
    (ok, rows), nums = _numbers(ref.control_poses, ref.control_factors)
    assert not ok, rows
    lim = dict((r[0], r[2]) for r in rows)
    assert nums["pose_rigidity"] > 3 * lim["pose_rigidity"]
    assert nums["factor_rigidity"] > 3 * lim["factor_rigidity"]


def test_float32_chain_passes():
    def f32(gt):
        P = [gt[0].astype(np.float32)]
        for i in range(1, len(gt)):
            P.append((P[-1] @ (ref.inv(gt[i - 1]) @ gt[i]).astype(
                np.float32)).astype(np.float32))
        return np.asarray(P, np.float64)
    def f32_factors(P, pairs):
        return np.asarray([(ref.inv(P[i]).astype(np.float32)
                            @ P[j].astype(np.float32)).astype(np.float32)
                           for i, j in pairs], np.float64)

    (ok, rows), nums = _numbers(f32, f32_factors)
    assert ok, rows
    assert nums["scan_step_p50_m"] < 1e-4
