"""The comparison that decides ``correct``: the program's answers over the
window against the plain reference (``reference.py``), each number beside
its limit (``limits/<workload>.json``).

Numbers, each the worst over the streams of the cell; a step error is the
error of a pose's step from the one before, against the true step:

    scan_step_p50_m     perception: the median error of the published
                        poses' steps over the window's scans (steps that
                        carry a new mapping correction left out)
    scan_step_max_m     perception: the largest such error
    pose_rigidity       perception: the worst departure of a published
                        pose from a rigid transform (|R^T R - I|)
    kf_missing_share    mapping: the share of the window's mapping ticks
                        that left no keyframe (each tick here moves metres,
                        past the 0.3 m that makes a keyframe)
    kf_step_max_m       mapping: the largest error of a keyframe's step
                        from the keyframe before, over the window's
                        keyframes
    loop_miss_share     loop: the share of the drive's revisit events
                        (the path within the loop search radius of itself
                        ``revisit_gap_s`` or more earlier) that got no
                        true factor at one of their scans; an event
                        counts once it has lasted three loop ticks
    false_factor_share  loop: the share of accepted loop factors more
                        than 1 m from the true relative pose
    factor_rigidity     loop: the worst departure of an accepted loop
                        factor from a rigid transform

Printed beside them and compared with nothing (PERF.md gives the
readings): the rotation steps, the median keyframe step, each loop
factor's error, ATE, and how far the program's loop-corrected keyframe
poses lie from a float64 re-solve of the graph of its own odometry and
accepted factors (``graph_gap_m``).

A number is within its limit when it is finite and at most the limit.
"""

from __future__ import annotations

import numpy as np

from . import reference as ref

NUMBERS = ("scan_step_p50_m", "scan_step_max_m", "pose_rigidity",
           "kf_missing_share", "kf_step_max_m", "loop_miss_share",
           "false_factor_share", "factor_rigidity")


def settle_scans(pipeline: dict) -> int:
    """Scans a revisit event lasts before the loop layer is held to it:
    three loop ticks (a mapping tick every ``process_interval`` s, a loop
    tick every ``check_every_ticks`` mapping ticks)."""
    per_map = max(1, round(pipeline["mapping"]["process_interval"]
                           / ref.SCAN_PERIOD))
    return 3 * per_map * int(pipeline["loop"]["check_every_ticks"])


def _worst(x) -> float:
    return float(np.max(x)) if len(x) else 0.0


def _median(x) -> float:
    return float(np.median(x)) if len(x) else 0.0


def _top(x, at, k=3):
    """The k largest of x with where they were: [[value, scan], ...]."""
    o = np.argsort(x)[::-1][:k]
    return [[float(x[i]), int(at[i])] for i in o]


def _spread(x) -> dict:
    """rms, median, 90th percentile and largest of x (None when empty)."""
    if not len(x):
        return None
    return {"rms": float(np.sqrt(np.mean(np.square(x)))),
            "p50": float(np.median(x)), "p90": float(np.percentile(x, 90)),
            "max": float(np.max(x))}


def numbers(config: dict, traffic: dict, published: np.ndarray,
            banks: list, first: int, map_at) -> tuple:
    """(numbers, diagnostics): ``published`` (n, S, 4, 4) poses of the
    scans handed in, ``banks`` per stream (``session.System.banks``), the
    window's first scan ``first``, the scans that ran a mapping tick
    (``map_at``; a loop tick runs only on one)."""
    n = published.shape[0]
    gt = ref.ground_truth(traffic, n)
    spec = ref.GraphSpec(config["pipeline"])
    radius = config["pipeline"]["loop"]["rs_search_radius"]
    gap_s = float(config["revisit_gap_s"])
    settle = settle_scans(config["pipeline"])
    worst = dict.fromkeys(NUMBERS, 0.0)
    diag = {"scans": int(n - first), "streams": []}
    ticks = sorted(i for i in map_at if i >= first)
    for s, b in enumerate(banks):
        kf = ref.pose6_to_mat(b["poses6"])
        kf_scans = np.clip(ref.scan_index(b["times"]), 0, n - 1)
        li, lj, lz = b["li"], b["lj"], b["lz"]
        sm, sd, s_at = ref.scan_steps(published[:, s], gt, first, map_at)
        km, kd, k_at = ref.keyframe_steps(kf, kf_scans, gt, first)
        fm, fd = ref.factor_errors(li, lj, lz, kf_scans, gt)
        gap_m, gap_deg = ref.graph_gap(spec, kf, b["odom_z"], li, lj, lz)
        kept = len(set(ticks) & set(kf_scans.tolist()))
        loops = ref.loop_precision_recall(li, lj, lz, kf_scans, gt, radius,
                                          gap_s, settle)
        rec, prec = loops["recall"], loops["precision"]
        got = {"scan_step_p50_m": _median(sm), "scan_step_max_m": _worst(sm),
               "pose_rigidity": ref.rigidity(published[first:, s]),
               "kf_missing_share": 1.0 - kept / len(ticks) if ticks else 0.0,
               "kf_step_max_m": _worst(km),
               "loop_miss_share": 0.0 if rec is None else 1.0 - rec,
               "false_factor_share": 0.0 if prec is None else 1.0 - prec,
               "factor_rigidity": ref.rigidity(lz)}
        for k, v in got.items():
            worst[k] = max(worst[k], v) if np.isfinite(v) else float("nan")
        diag["streams"].append({
            "keyframes": int(len(kf)),
            "worst_scan_steps_m": _top(sm, s_at),
            "worst_scan_steps_deg": _top(sd, s_at),
            "worst_kf_steps_m": _top(km, k_at),
            "worst_kf_steps_deg": _top(kd, k_at),
            "factors_m": _spread(fm), "factors_deg": _spread(fd),
            "graph_gap_m": gap_m, "graph_gap_deg": gap_deg,
            "scan_steps_m": _spread(sm), "scan_steps_deg": _spread(sd),
            "kf_steps_m": _spread(km), "kf_steps_deg": _spread(kd),
            "ate_published_m": ref.ate(published[:, s], gt),
            "ate_keyframes_m": ref.ate(kf, gt[kf_scans]) if len(kf) else None,
            "loops": loops,
        })
    return worst, diag


def verdict(nums: dict, limits: dict) -> tuple:
    """(correct, [[name, number, limit], ...]); every number needs a
    limit."""
    rows = [[k, nums[k], float(limits[k])] for k in NUMBERS]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok), rows
