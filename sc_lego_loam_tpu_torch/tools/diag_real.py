"""Real-path accuracy diagnosis: per-scan relative-pose errors of the
``real`` block's configurations (the counterpart of the JAX package's
``tools/diag_real.py``).

    python -m sc_lego_loam_tpu_torch.tools.diag_real [variant ...]
        [--device cuda]        (default variant: lidar; BENCH_SEED, 11)

Variants over the bench's motion-skewed figure-8 (240 scans, capture
order):

  lidar          ``runner.mulran_engine_config()``: carried-twist de-skew
  imu            the same with the IMU on and the bench's 100 Hz stream
  ordered        ``synthetic_config()`` on the instantaneous, beam-ordered
                 figure-8 (the undistorted control, same course)
  odo            lidar with mapping and loop closure never ticking
  odo-nodeskew   odo with the de-skew off

Each runs through ``tools.bench.run_engine`` (the bench's warm-up) and
prints scans/s, ATE (whole and steady), keyframes and loops; the mean /
p95 / max of the per-scan rotation (deg) and translation (m) errors after
the warm-up (``rel_errors``); the rotation-scale ratio |est rotation| /
|gt rotation| over scans that turn more than 0.5 deg (~0.5: the solver
aligns the scan middle, the de-skew is dead; ~1.0: unbiased); and the
eight worst scans.  ``--device`` defaults to ``cuda`` and fails without a
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..config import ImuConfig, synthetic_config
from ..runner import mulran_engine_config
from ..utils import evaluate
from . import bench

VARIANTS = ("lidar", "imu", "ordered", "odo", "odo-nodeskew")


def _angle_deg(R):
    return np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def rel_errors(est, gt):
    """Per-scan relative-pose errors: (rot deg, trans m) arrays."""
    n = min(len(est), len(gt))
    rot, trans = [], []
    for i in range(1, n):
        z_est = np.linalg.inv(est[i - 1]) @ est[i]
        z_gt = np.linalg.inv(gt[i - 1]) @ gt[i]
        e = np.linalg.inv(z_gt) @ z_est
        rot.append(_angle_deg(e[:3, :3]))
        trans.append(np.linalg.norm(e[:3, 3]))
    return np.asarray(rot), np.asarray(trans)


def rotation_scale(est, gt, warmup):
    """|est per-scan rotation| / |gt rotation| for the scans after
    ``warmup`` whose ground truth turns more than 0.5 deg."""
    n = min(len(est), len(gt))
    ratios = []
    for i in range(max(warmup, 1), n):
        ae = _angle_deg((np.linalg.inv(est[i - 1]) @ est[i])[:3, :3])
        ag = _angle_deg((np.linalg.inv(gt[i - 1]) @ gt[i])[:3, :3])
        if ag > 0.5:
            ratios.append(ae / ag)
    return np.asarray(ratios)


def variant_config(variant, real=mulran_engine_config,
                   ordered=synthetic_config):
    """The engine configuration of a variant."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    if variant == "ordered":
        return ordered()
    rcfg = real()
    if variant == "imu":
        return rcfg.replace(imu=ImuConfig(enabled=True))
    if variant == "lidar":
        return rcfg
    odom = rcfg.odom if variant == "odo" else dataclasses.replace(
        rcfg.odom, deskew=False)
    return rcfg.replace(
        odom=odom,
        mapping=dataclasses.replace(rcfg.mapping, process_interval=1e9),
        loop=dataclasses.replace(rcfg.loop, enabled=False))


def drive(variant, cfg, seed, n_scans=bench.N_SCANS):
    """(scans, valids, gt, imu stream or None) of a variant."""
    if variant == "ordered":
        scans, valids, gt = bench.get_sequence(
            cfg.lidar, n_scans, trajectory="figure8", noise=0.01, seed=seed,
            shuffle=False, radius=30.0, loops=1.05)
    else:
        scans, valids, gt = bench.get_sequence(
            cfg.lidar, n_scans, trajectory="figure8", noise=0.01, seed=seed,
            shuffle=False, skew=True, radius=30.0, loops=1.05)
    imu = bench.make_imu(gt, seed=seed) if variant == "imu" else None
    return scans, valids, gt, imu


def diagnose(variant, cfg, scans, valids, gt, device, card,
             warmup=bench.WARMUP, imu=None):
    """Run one variant and print its tables; returns a dict of the
    figures."""
    engine, fps = bench.run_engine(cfg, scans, valids, warmup, imu=imu,
                                   device=str(device))
    est = engine.trajectory_array()
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    ate_steady = evaluate.ate_rmse(est[warmup:], gt[warmup:len(est)])
    rot, trans = rel_errors(est, gt)
    ratios = rotation_scale(est, gt, warmup)
    w = min(warmup, max(len(rot) - 1, 0))
    out = dict(variant=variant, fps=fps, ate=ate, ate_steady=ate_steady,
               kf=int(engine.m.kf.count), loops=int(engine.loops_closed),
               rot=rot, trans=trans, ratios=ratios)
    print(f"\n=== {variant}: fps={fps:.1f} ate={ate:.3f} "
          f"steady={ate_steady:.3f} kf={out['kf']} loops={out['loops']} "
          f"[{card}]", flush=True)
    print(f"rel-rot deg  (post-warmup): mean={rot[w:].mean():.3f} "
          f"p95={np.percentile(rot[w:], 95):.3f} max={rot[w:].max():.3f}")
    print(f"rel-trans m  (post-warmup): mean={trans[w:].mean():.3f} "
          f"p95={np.percentile(trans[w:], 95):.3f} "
          f"max={trans[w:].max():.3f}")
    if len(ratios):
        print(f"rot scale est/gt (|gt rot|>0.5deg): "
              f"mean={ratios.mean():.3f} p10={np.percentile(ratios, 10):.3f} "
              f"p90={np.percentile(ratios, 90):.3f} n={len(ratios)}")
    print("worst scans (idx, rot deg, trans m):")
    for i in np.argsort(trans)[-8:][::-1]:
        print(f"  {i + 1:4d}  {rot[i]:7.3f}  {trans[i]:7.3f}", flush=True)
    del engine
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=["lidar"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = bench.require_device(args.device)
    card = bench.card_line(device)
    seed = int(os.environ.get("BENCH_SEED", "11"))
    for variant in args.variants:
        cfg = variant_config(variant)
        scans, valids, gt, imu = drive(variant, cfg, seed)
        diagnose(variant, cfg, scans, valids, gt, device, card, imu=imu)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
