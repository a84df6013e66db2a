"""Drive the SLAM engine end to end on a synthetic sequence.

    python -m sc_lego_loam_tpu_torch.tools.run_synthetic [--device cuda]
        [--scans N] [--traj straight|figure8] [--preset tiny|os1-64|vlp-16]
        [--skew] [--export PREFIX]

Prints per-scan poses, the final ATE against ground truth, the keyframe and
loop-closure counts and the per-stage host timings, and with ``--export``
writes a PLY map, a TUM trajectory and an NPZ checkpoint.  Exits 0 when the
ATE is under 1.0 m.  ``--device`` defaults to ``cuda`` and fails without a
card; ``--device cpu`` runs the kernels' plain versions (slow at os1-64).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from ..config import (OdometryConfig, synthetic_config, tiny_test_config,
                      vlp16_config)
from ..pipeline import SlamEngine
from ..utils import evaluate, export, synthetic


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=30)
    ap.add_argument("--traj", default="straight",
                    choices=["straight", "figure8"])
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "os1-64", "vlp-16"])
    ap.add_argument("--step", type=float, default=0.4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--skew", action="store_true",
                    help="motion-distorted scans + deskew=True odometry "
                    "(the real-data / MulRan code path)")
    ap.add_argument("--export", default=None,
                    help="optional path prefix for map/trajectory export")
    args = ap.parse_args(argv)

    if args.preset == "tiny":
        cfg = tiny_test_config()
    elif args.preset == "vlp-16":
        # 16-beam sparse-lidar variant, adapted for instantaneous
        # synthetic clouds.
        base = vlp16_config()
        cfg = base.replace(
            lidar=dataclasses.replace(base.lidar, ordered=True),
            odom=OdometryConfig(deskew=False, min_surf_points=30,
                                eig_threshold=2.0))
    else:
        cfg = synthetic_config()
    if args.skew:
        cfg = cfg.replace(
            lidar=dataclasses.replace(cfg.lidar, ordered=False),
            odom=dataclasses.replace(cfg.odom, deskew=True))

    print(f"generating {args.scans}-scan synthetic sequence "
          f"({cfg.lidar.name}, {args.traj}{', skewed' if args.skew else ''})"
          "...", flush=True)
    kw = dict(step=args.step) if args.traj == "straight" else dict(
        radius=30.0, loops=1.05)
    scans, valids, gt = synthetic.make_sequence(
        cfg.lidar, args.scans, trajectory=args.traj, noise=0.01,
        seed=args.seed, shuffle=False if args.skew else not cfg.lidar.ordered,
        skew=args.skew, **kw)

    engine = SlamEngine(cfg, device=args.device)
    engine.trace.on()           # its host spans are printed at the end
    t0 = time.time()
    for i in range(args.scans):
        ts = time.time()
        pose = engine.process_scan(scans[i], valids[i], t=i * 0.1)
        p = pose[:3, 3].cpu().numpy()
        print(f"scan {i:3d}: pos=({p[0]:7.2f},{p[1]:7.2f},{p[2]:6.2f})  "
              f"gt=({gt[i][0,3]:7.2f},{gt[i][1,3]:7.2f},{gt[i][2,3]:6.2f})  "
              f"kf={int(engine.map.kf.count)} loops={int(engine.loops_closed)} "
              f"[{time.time()-ts:5.2f}s]", flush=True)
    wall = time.time() - t0

    est = engine.trajectory_array()
    ate = evaluate.ate_rmse(est, gt[:len(est)])
    rpe_t, rpe_r = evaluate.rpe(est, gt[:len(est)])
    print(f"\n=== {args.scans} scans in {wall:.1f}s "
          f"({args.scans/wall:.2f} scans/s, a device read per scan for the "
          f"printout) on {engine.device} ===")
    print(f"ATE RMSE: {ate:.3f} m   RPE: {rpe_t:.3f} m / "
          f"{np.degrees(rpe_r):.3f} deg")
    print(f"keyframes: {int(engine.map.kf.count)}  "
          f"loop closures: {int(engine.loops_closed)}")
    print("\nper-stage host timings (after the first two samples):")
    print(engine.trace.table(skip_first=2))

    if args.export:
        pts = export.global_map_points(engine)
        export.save_ply(args.export + "_map.ply", pts)
        export.save_trajectory_tum(args.export + "_traj.txt",
                                   engine.trajectory_times(), est)
        export.save_checkpoint(args.export + "_ckpt.npz", engine)
        print(f"exported map ({len(pts)} pts) + trajectory + checkpoint "
              f"to {args.export}_*")

    ok = ate < 1.0
    print("VERDICT:", "PASS" if ok else "FAIL", f"(ate={ate:.3f})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
